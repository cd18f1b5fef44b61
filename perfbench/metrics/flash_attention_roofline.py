"""K3's share of its roofline in the traced window: the least time of its
calls (``roofline.attention_bound`` for the shared attention's shapes: batch
x heads rows of q, causal, the mix's rows of tokens, the configuration's
head dim, bf16) over the device time of the flash-attention kernel's
launches.  Nothing to read where the window ran no such launch."""

from perfbench import roofline, roofline_hybrid, tracing


def read(run: dict):
    trace = run.get("trace")
    if not trace:
        return None
    secs, calls = tracing.kernel_time(trace, "flash_attention_wgmma", "flash_attention_fwd")
    if not calls or secs <= 0:
        return None
    d, mix = roofline_hybrid.dims(run["config"]), run["mix"]
    itemsize = 2 if run["config"]["dtype"] in ("bfloat16", "float16") else 4
    bound, _ = roofline.attention_bound(bh=mix["batch"] * d["attn_heads"], bk=mix["batch"] * d["kv_heads"],
                                        sq=mix["seq"], sk=mix["seq"], d=d["head_dim"], itemsize=itemsize,
                                        causal=True)
    return 100.0 * calls * bound / secs
