"""Batched serving on the PyTorch/CUDA port: prefill a batch of prompts,
decode greedily with the KV cache, then disseminate the outputs through a
``{"type": "cache"}`` tier — the twin of ``examples/serve_decode.py`` on
``repro_torch``, with a reduced config and random weights from seed 0.

Prefill attention goes through the hand-written flash-attention kernel on
the card (``attn_impl="pallas"``, the reference's name for its kernel
path); on the CPU the same call takes the kernel's plain PyTorch version.

    PYTHONPATH=src python examples/serve_decode_torch.py --tokens 16            # on the card
    PYTHONPATH=src python examples/serve_decode_torch.py --tokens 16 --device cpu
"""

import argparse
import dataclasses
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import build_fdb
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, init_params, prefill


def disseminate(gen: np.ndarray, logits: np.ndarray, n_consumers: int) -> dict:
    """Archive the generated outputs once, then fan them out to
    *n_consumers* concurrent readers through a cache tier; returns the
    cache's telemetry."""
    batch, n_tokens = gen.shape
    with tempfile.TemporaryDirectory() as td:
        cfg = {
            "type": "cache",
            "max_bytes": 64 << 20,
            "inner": {"backend": "posix", "root": td, "schema": "nwp-posix"},
        }
        with build_fdb(cfg) as fdb:
            # one field per (decode step, batch lane): the step's token id +
            # final-position logits row, as the product a consumer would pull
            for step in range(n_tokens):
                for lane in range(batch):
                    key = {"class": "rd", "stream": "oper", "expver": "0001",
                           "date": "20240601", "time": "0000", "type": "fc",
                           "levtype": "ml", "number": str(lane),
                           "levelist": "1", "step": str(step), "param": "130"}
                    payload = (gen[lane, step].tobytes()
                               + logits[lane].astype(np.float32).tobytes())
                    fdb.archive(key, payload)
            fdb.flush()

            request = {"class": "rd", "stream": "oper", "expver": "0001",
                       "date": "20240601", "time": "0000", "type": "fc",
                       "levtype": "ml", "number": [str(b) for b in range(batch)],
                       "levelist": "1", "step": [str(s) for s in range(n_tokens)],
                       "param": "130"}
            totals = []

            def consumer() -> None:
                total = 0
                for data in fdb.retrieve_many(request).read_all().values():
                    assert data is not None
                    total += len(data)
                totals.append(total)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=consumer) for _ in range(n_consumers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            dt = time.perf_counter() - t0
            snap = fdb.cache_snapshot()
        assert len(totals) == n_consumers and len(set(totals)) == 1, totals
        print(f"disseminate: {n_consumers} consumers x {batch * n_tokens} fields "
              f"in {dt * 1e3:.1f} ms through the cache tier")
        print(f"  hit rate {snap['hit_rate']:.3f} "
              f"({snap['hits']} hits / {snap['misses']} misses / "
              f"{snap['coalesced']} coalesced), "
              f"{snap['bytes_served_per_backend_byte']:.1f} bytes served "
              f"per backend byte "
              f"({snap['bytes_served']} cache B vs {snap['bytes_backend']} backend B)")
    return snap


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--consumers", type=int, default=4,
                    help="concurrent readers pulling the outputs through the cache tier")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(reduced(get_config(args.arch)), attn_impl="pallas")
    print(f"arch={cfg.name} (reduced {cfg.n_layers}L d={cfg.d_model}) on {dev} "
          f"attn={cfg.attn_impl} batch={args.batch} prompt={args.prompt_len} gen={args.tokens}")

    params = init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    cache = init_cache(cfg, args.batch, args.prompt_len + args.tokens, device=dev)

    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill(params, cfg, torch.tensor(prompts, device=dev), cache)
        nxt = torch.argmax(logits[:, : cfg.vocab], dim=-1).int()[:, None]
        nxt.cpu()  # waits for the device
        t_prefill = time.perf_counter() - t0

        out_tokens = []
        t0 = time.perf_counter()
        for _ in range(args.tokens):
            out_tokens.append(nxt)
            logits, cache = decode_step(params, cfg, nxt, cache)
            nxt = torch.argmax(logits[:, : cfg.vocab], dim=-1).int()[:, None]
        gen = torch.cat(out_tokens, dim=1).cpu().numpy()
        t_decode = time.perf_counter() - t0

    print(f"prefill: {t_prefill*1e3:.1f} ms "
          f"({args.batch * args.prompt_len / t_prefill:,.0f} tok/s)")
    print(f"decode : {t_decode*1e3:.1f} ms "
          f"({args.batch * args.tokens / t_decode:,.0f} tok/s, batch={args.batch})")
    print("sample generated ids:", gen[0][:10].tolist())
    assert int(cache["pos"][0]) == args.prompt_len + args.tokens

    disseminate(gen, logits.float().cpu().numpy(), args.consumers)


if __name__ == "__main__":
    main()
