"""The host cost of one flash-attention call through its public wrapper, for
one or more checkouts of the port, compared on one card.

    python3 tools/k3_call_cost.py --src src [--src OTHER/src ...] [--rounds 6] [--reps 400]

Needs one CUDA card and nvcc.  Each ``--src`` is the ``src`` directory of a
checkout (this one, or an older one unpacked with ``git archive``); each is
timed in a subprocess of its own that imports ``repro_torch`` from there,
builds its kernels and calls
``repro_torch.kernels.flash_attention.ops.flash_attention`` at the shortest
prompt that ``chip_smoke.py`` phase 5 serves: qwen2.5-3b's 16 query heads
over 2 KV heads of 128, 123 tokens, bf16, causal (the ``wgmma`` instance).
The sources run in turn, forwards then backwards, ``--rounds`` times (A B B
A ... for two), so that drift of the card or its host falls on both.  Each run
reports the median of ``--reps`` calls of:

- ``idle_ms``: one call from an idle stream, CUDA events around it (the
  wrapper's host work and the launch, then the kernel);
- ``host_us``: host clock per call over 20 back-to-back calls, after which
  the stream is synchronised (the wrapper's host cost, while the card runs
  behind it);
- ``device_ms``: CUDA events around 20 back-to-back calls, over their count;
- ``kernel_call_us``: the host clock of ``host_us`` for
  ``kernel.flash_attention_call`` on the flattened, contiguous tensors, the
  launch beneath the wrapper: a control, the same code in every checkout,
  that shows how much of a difference in ``host_us`` is the process's.

Prints one line per run and, last, a JSON object of them all.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPE = {"b": 1, "sq": 123, "kh": 2, "g": 8, "d": 128}

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import _build, launches
from repro_torch.kernels.flash_attention import kernel as fk, ops
shape, reps = json.loads(sys.argv[2]), int(sys.argv[3])
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_build.build_all([fk.LIBRARY])
gen = torch.Generator(dev).manual_seed(0)
b, s, kh, g, d = (shape[k] for k in ("b", "sq", "kh", "g", "d"))
q = torch.randn((b, s, kh, g, d), generator=gen, device=dev, dtype=torch.bfloat16)
k = torch.randn((b, s, kh, d), generator=gen, device=dev, dtype=torch.bfloat16)
v = torch.randn((b, s, kh, d), generator=gen, device=dev, dtype=torch.bfloat16)
call = lambda: ops.flash_attention(q, k, v, causal=True)
for _ in range(20):
    call()
torch.cuda.synchronize()
idle, host, device = [], [], []
for _ in range(reps):
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record(); call(); e.record(); e.synchronize()
    idle.append(a.elapsed_time(e))
qf = q.permute(0, 2, 3, 1, 4).reshape(b * kh * g, s, d).contiguous()
kf, vf = (t.permute(0, 2, 1, 3).reshape(b * kh, s, d).contiguous() for t in (k, v))
direct = lambda: fk.flash_attention_call(qf, kf, vf, groups=g, causal=True)
kernel_call = []
for _ in range(max(1, reps // 20)):
    for fn, times in ((call, host), (direct, kernel_call)):
        torch.cuda.synchronize()
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(20):
            fn()
        e.record()
        times.append((time.perf_counter() - t0) / 20 * 1e6)
        e.synchronize()
        if fn is call:
            device.append(a.elapsed_time(e) / 20)
print(json.dumps({"idle_ms": statistics.median(idle), "host_us": statistics.median(host),
                  "device_ms": statistics.median(device),
                  "kernel_call_us": statistics.median(kernel_call),
                  "launches": launches.snapshot()["flash_attention"],
                  "instances": launches.by("flash_attention", "instance")}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src directory; give two or more to compare")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=400)
    args = ap.parse_args()
    srcs = [str(Path(s).resolve()) for s in args.src]
    order = []
    for r in range(args.rounds):
        order += srcs if r % 2 == 0 else srcs[::-1]
    runs = []
    for src in order:
        out = subprocess.run([sys.executable, "-c", CHILD, src, json.dumps(SHAPE), str(args.reps)],
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        rec = {"src": src, **json.loads(out.stdout.strip().splitlines()[-1])}
        runs.append(rec)
        print(f"[k3_call_cost] {src}: one call from idle {rec['idle_ms']:.4f} ms, host "
              f"{rec['host_us']:.2f} us a call back to back (the launch beneath it "
              f"{rec['kernel_call_us']:.2f} us), device {rec['device_ms']:.4f} ms a call, "
              f"instances {rec['instances']}", flush=True)
    summary = {src: {key: statistics.median(r[key] for r in runs if r["src"] == src)
                     for key in ("idle_ms", "host_us", "device_ms", "kernel_call_us")}
               for src in srcs}
    print(json.dumps({"shape": SHAPE, "runs": runs, "median_by_src": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
