"""The hybrid scoring pass's share of the card's bf16 peak at 4096-token
rows: the forward's model flops of the window's tokens, counted from the
configuration's shapes by ``roofline_hybrid``, over the window, on the host
clock."""

from perfbench import roofline, roofline_hybrid


def read(run: dict):
    flops = roofline_hybrid.forward_flops_per_token(run["config"], run["mix"]["seq"]) * run["tokens"]
    return 100.0 * flops / run["window_s"] / roofline.BF16_PEAK if run["tokens"] else None
