"""The one-pass RMSNorm kernel's wrapper on the CPU, and where the models call it.

A CPU tensor goes to the plain version (``kernels/rms_norm/ref.py``, which
``models.ops.rms_norm`` is) itself, so the wrapper equals it bit for bit and
counts no launch; the plain version gates and splits into groups as the
mixer's gated norm did before it moved there; shapes the kernel does not take raise on every device,
and the wrapper has no backward.  Under ``attn_impl="pallas"`` the train
forward reaches the wrapper at every norm the kernel serves (the mixers'
gated norms, ``ssm.norm_in``, the shared blocks' two norms, the final norm);
``"naive"``, prefill and decode never do.  A DTensor is normalised rank by
rank through the wrapper, unless its groups are split across ranks.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.device import default_device, set_default_device  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params, prefill, train_loss  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ops as tops  # noqa: E402


@pytest.fixture(autouse=True)
def cpu():
    before = default_device()
    set_default_device("cpu")
    yield
    set_default_device(before)


def norm_inputs(seed: int, shape: tuple, dtype):
    rng = np.random.default_rng(seed)
    y, z = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2).to(dtype)
            for _ in range(2))
    scale = torch.from_numpy(rng.standard_normal(shape[-1], dtype=np.float32)).to(dtype)
    return y, z, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("width", [8, 1024, 3584, 7168])
def test_wrappers_are_the_plain_versions_on_the_cpu(dtype, groups, width):
    """Group widths of the cells (1024, 3584, 7168) and the narrowest the
    kernel takes; the same bits as the plain version, no launch counted; and
    the plain version gated over groups is the gate, then each group's norm."""
    y, z, scale = norm_inputs(width + groups, (2, 5, groups * width), dtype)
    launches.reset()
    gated = rn.rms_norm(y, scale, 1e-5, z, groups)
    plain = rn.rms_norm(y, scale, 1e-6)
    grouped = rn.rms_norm(y, scale, 1e-6, groups=groups)
    assert launches.snapshot() == {}
    assert gated.dtype == dtype and gated.shape == y.shape
    assert torch.equal(gated, rn.ref.rms_norm(y, scale, 1e-5, z, groups))
    assert torch.equal(plain, tops.rms_norm(y, scale, 1e-6))
    assert torch.equal(grouped, rn.ref.rms_norm(y, scale, 1e-6, groups=groups))
    g = y.reshape(2, 5, groups, width)
    assert torch.equal(grouped, tops.rms_norm(g, scale.reshape(groups, width), 1e-6).reshape(y.shape))
    gz = (y * torch.nn.functional.silu(z)).reshape(2, 5, groups, width)
    assert torch.equal(gated, tops.rms_norm(gz, scale.reshape(groups, width), 1e-5).reshape(y.shape))


def test_wrappers_have_no_backward():
    """As the other kernels' wrappers, on the CPU too; a forward under grad mode works."""
    y, z, scale = norm_inputs(3, (2, 4, 16), torch.float32)
    out = rn.rms_norm(y.requires_grad_(True), scale)
    assert out.requires_grad and torch.equal(out, tops.rms_norm(y, scale))
    with pytest.raises(NotImplementedError, match="no VJP"):
        out.sum().backward()
    out = rn.rms_norm(y, scale, 1e-5, z.requires_grad_(True), 2)
    with pytest.raises(NotImplementedError, match="no VJP"):
        out.sum().backward()


@pytest.mark.parametrize("case,match", [
    ("width 12", "multiple of 8"),
    ("two groups of 4", "multiple of 8"),
    ("three groups of 16", "into 3 groups"),
    ("gate of another shape", "gate of x's shape"),
    ("scale of the wrong length", r"\(32,\) scale"),
])
def test_wrappers_refuse_shapes_the_kernel_does_not_take(case, match):
    """On every device, so that the CPU and the card take the same inputs."""
    y, z, scale = norm_inputs(4, (2, 3, 32), torch.bfloat16)
    call = {
        "width 12": lambda: rn.rms_norm(y[..., :12], scale[:12]),
        "two groups of 4": lambda: rn.rms_norm(y[..., :8], scale[:8], 1e-5, z[..., :8], 2),
        "three groups of 16": lambda: rn.rms_norm(y[..., :16], scale[:16], 1e-5, z[..., :16], 3),
        "gate of another shape": lambda: rn.rms_norm(y, scale, 1e-5, z[:1]),
        "scale of the wrong length": lambda: rn.rms_norm(y, scale[:16]),
    }[case]
    with pytest.raises(ValueError, match=match):
        call()


def expected_calls(cfg) -> dict:
    """Wrapper calls of one train forward under "pallas": the final norm; each
    ssm or hybrid layer's norm_in and gated norm; two norms a shared block."""
    if cfg.family not in ("ssm", "hybrid"):
        return {"rms_norm": 1, "gated_rms_norm": 0}
    if cfg.published_hybrid:
        sites = len(cfg.hybrid_sites)
    else:
        sites = sum(tmodel._is_shared_site(cfg, i) for i in range(cfg.n_layers))
    return {"rms_norm": cfg.n_layers + 1 + 2 * sites, "gated_rms_norm": cfg.n_layers}


def counting(monkeypatch) -> dict:
    """Count the wrapper's calls, with the gate and without (each still runs)."""
    calls = {"rms_norm": 0, "gated_rms_norm": 0}
    wrapped = rn.ops.rms_norm

    def call(x, scale, eps=1e-5, z=None, groups=1):
        calls["rms_norm" if z is None else "gated_rms_norm"] += 1
        return wrapped(x, scale, eps, z, groups)

    monkeypatch.setattr(rn.ops, "rms_norm", call)
    return calls


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b-instruct", "zamba2-7b", "qwen2.5-3b"])
def test_scoring_under_pallas_reaches_the_wrappers_at_every_norm_site(monkeypatch, arch):
    """Reduced configs scored under "pallas" and "naive": the same loss on the
    CPU, and every dispatched norm through a wrapper under "pallas" only."""
    base = reduced(get_config(arch))
    params = init_params(base, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(1, base.vocab, (2, 65)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    losses = {}
    for impl in ("naive", "pallas"):
        with monkeypatch.context() as mp:
            calls = counting(mp)
            with torch.no_grad():
                losses[impl] = float(train_loss(params, dataclasses.replace(base, attn_impl=impl), batch)[0])
        want = expected_calls(base) if impl == "pallas" else {"rms_norm": 0, "gated_rms_norm": 0}
        assert calls == want, (impl, calls)
    assert np.isfinite(losses["naive"]) and losses["pallas"] == losses["naive"]


def test_prefill_and_decode_keep_the_plain_norms(monkeypatch):
    """mamba2-370m's mixers and zamba2-7b's mixers and shared blocks: prefill
    and decode under "pallas" call no wrapper."""
    calls = counting(monkeypatch)
    for arch in ("mamba2-370m", "zamba2-7b"):
        cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl="pallas")
        assert arch != "zamba2-7b" or any(tmodel._is_shared_site(cfg, i) for i in range(cfg.n_layers))
        params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(1, cfg.vocab, (2, 16)))
        with torch.no_grad():
            cache = init_cache(cfg, 2, 32)
            logits, cache = prefill(params, cfg, tokens, cache)
            logits, cache = decode_step(params, cfg, tokens[:, :1], cache)
        assert torch.isfinite(logits).all()
        assert calls == {"rms_norm": 0, "gated_rms_norm": 0}, (arch, calls)


def test_a_dtensor_goes_to_the_plain_versions(monkeypatch):
    """On a one-rank gloo mesh.  Sharded over its width, a DTensor goes to
    the plain versions, which complete the sum of squares across shards; the
    kernel's path is not taken (and on the CPU nothing is counted under
    rms_norm.plain_on_card).  Sharded over its rows, or replicated, each rank's rows
    take the kernel's path (here its plain version) through map_shards."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    y, z, scale = norm_inputs(5, (2, 3, 32), torch.float32)
    reached = []
    norm = rn.ops._norm

    def kernel_path(x, *args):
        if not reached:
            raise AssertionError("a width-sharded DTensor reached the kernel's path")
        assert not isinstance(x, DTensor), "the kernel's path takes a rank's local rows"
        reached.append(x.shape)
        return norm(x, *args)

    monkeypatch.setattr(rn.ops, "_norm", kernel_path)
    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        launches.reset()
        mesh = init_device_mesh("cpu", (1,))
        ys, zs = (distribute_tensor(t, mesh, [Shard(2)]) for t in (y, z))
        ss = distribute_tensor(scale, mesh, [Shard(0)])
        out = rn.rms_norm(ys, ss)
        gated = rn.rms_norm(ys, ss, 1e-5, zs)
        assert isinstance(out, DTensor) and isinstance(gated, DTensor)
        torch.testing.assert_close(out.full_tensor(), tops.rms_norm(y, scale))
        torch.testing.assert_close(gated.full_tensor(), rn.ref.rms_norm(y, scale, 1e-5, z))
        assert launches.snapshot() == {}
        reached.append(None)  # from here on the kernel's path is expected
        for placement in (Shard(0), Shard(1), Replicate()):
            ys, zs = (distribute_tensor(t, mesh, [placement]) for t in (y, z))
            ss = distribute_tensor(scale, mesh, [Replicate()])
            out = rn.rms_norm(ys, ss, 1e-5, groups=2)
            gated = rn.rms_norm(ys, ss, 1e-5, zs, 2)
            assert isinstance(out, DTensor) and out.placements == (placement,)
            assert torch.equal(gated.full_tensor(), rn.ref.rms_norm(y, scale, 1e-5, z, 2))
            assert torch.equal(out.full_tensor(),
                               tops.rms_norm(y.reshape(2, 3, 2, 16), scale.reshape(2, 16)).reshape(y.shape))
        assert reached[1:] == [y.shape] * 6, reached
        assert launches.snapshot() == {}
    finally:
        dist.destroy_process_group()
