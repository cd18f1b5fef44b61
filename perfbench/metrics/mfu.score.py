"""The scoring pass's share of the card's bf16 peak: the forward's model flops
of the window's tokens, counted from the configuration's shapes, over the
window, on the host clock."""

from perfbench import roofline


def read(run: dict):
    flops = roofline.forward_flops_per_token(run["config"], run["mix"]["seq"]) * run["tokens"]
    return 100.0 * flops / run["window_s"] / roofline.BF16_PEAK if run["tokens"] else None
