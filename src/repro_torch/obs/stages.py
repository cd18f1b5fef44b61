"""Named stages of the port's models, for ``torch.profiler``.

:func:`stage` marks a stretch of a model's forward as one range of the
profiler's own timeline.  Any ``torch.profiler`` trace of the port that
records the host (``ProfilerActivity.CPU``; a trace of the card alone holds
no range) shows these names: ``export_chrome_trace`` draws them as ranges
above the kernels they launched (Perfetto loads the file), and
``key_averages(group_by_stack_n=...)`` or the event tree in ``prof.events()``
puts each kernel under its stage.  ``tools/score_stages.py`` sums the card's
time by stage for a scoring cell of the benchmark.
The ssm and hybrid forward of ``forward_hidden`` and ``train_loss`` is
covered end to end by flat, non-nested stages:

- ``model.embed``, ``model.final_norm``, ``model.head_ce`` (the chunked
  cross-entropy of ``train_loss``);
- in each layer ``ssm.norm_in``, ``ssm.in_proj``, ``ssm.conv``, ``ssm.scan``
  (the SSD scan with its layout copies and casts), ``ssm.gate_norm`` and
  ``ssm.out_proj``;
- at each site of the published Zamba2's shared blocks ``shared.attn_in``
  (the concat, the input norm, q, k, v and RoPE), ``shared.attn`` (K3 with
  its layout copies), ``shared.attn_out`` (o and the pre-FF norm),
  ``shared.mlp`` (gate and up with the site's adapter, the GELU product,
  down) and ``shared.linear`` (the site's linear and the add into the
  mixer's input).

Only the residual adds fall under no stage.  Nothing turns the stages on
but a running profiler: outside a profile a stage costs one flag check and
returns the tracer's null span, so it allocates nothing here and changes
nothing the forward computes.
"""

from __future__ import annotations

import torch.autograd.profiler as _profiler
from torch.profiler import record_function

from .tracer import _NULL_SPAN

__all__ = ["stage"]


def stage(name: str):
    """A context manager: the profiler's range ``name`` while a profiler
    records, else the null span."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _NULL_SPAN
