"""End-to-end run on the PyTorch port: train a language model with the
full fault-tolerant stack — FDB-backed async checkpointing, deterministic
data pipeline, auto-resume, optional failure injection.  The twin of
examples/train_lm.py.

    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --reduced --steps 20 --fail-at 12
    PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-370m --steps 30 --batch 8 --seq 2048

It runs on the CUDA card unless ``--device cpu`` asks for the CPU.
``--reduced`` trains the small same-family config of ``configs.reduced``.
"""

import argparse
import os
import tempfile
import time

from repro_torch.configs import TrainConfig, get_config, reduced
from repro_torch.core import CHECKPOINT_SCHEMA, make_fdb
from repro_torch.core.daos import DaosEngine
from repro_torch.training import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--arch", default="nwp-100m")
    ap.add_argument("--reduced", action="store_true", help="train reduced(arch), the CPU-sized config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="daos", choices=["daos", "posix"])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "repro_torch_fdb_train"))
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.name}{' (reduced)' if args.reduced else ''} N={cfg.param_count()/1e6:.1f}M "
          f"params batch={args.batch} seq={args.seq}")

    hp = TrainConfig(
        learning_rate=3e-4, warmup_steps=20, total_steps=args.steps,
        checkpoint_every=args.ckpt_every, async_checkpoint=True,
    )
    if args.backend == "daos":
        fdb = make_fdb("daos", schema=CHECKPOINT_SCHEMA, engine=DaosEngine())
    else:
        fdb = make_fdb("posix", schema=CHECKPOINT_SCHEMA, root=args.root)

    trainer = Trainer(cfg, hp, fdb, run="train_lm", global_batch=args.batch, seq_len=args.seq,
                      device=args.device)
    t0 = time.time()
    report = trainer.train(args.steps, fail_at=args.fail_at, log_every=10)
    dt = time.time() - t0
    tok_per_s = args.steps * args.batch * args.seq / dt
    print(f"\ndone: {report.final_step} steps, {report.restarts} restart(s), "
          f"{dt:.1f}s wall, {tok_per_s:,.0f} tok/s ({trainer.device.type})")
    print(f"first/last logged loss: {report.losses[0][1]:.3f} -> {report.losses[-1][1]:.3f}")
    print(f"checkpoints visible: {trainer.ckpt.available_steps()}")
    trainer.pipeline.close()


if __name__ == "__main__":
    main()
