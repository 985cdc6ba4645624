"""Observers of the model-layer kernels' launches on the card.

On the card the wrappers of ``kernels/ops.py`` call each kernel's
launcher (``*_cuda``) directly, not through its custom op (the custom ops
are the host's), so a ``TorchDispatchMode`` sees the launch's output
allocations and nothing of the kernel.  Each launcher of the attention,
SSD and sLSTM kernels therefore reports its launch here, where it counts
it: the name of the custom op whose work it does (``kernels/flops.py``
prices it), the launcher's arguments (its operands first, in the
formula's order) and the tensors it wrote.
:class:`repro_torch.core.opcost.OpRecorder` listens while it records.
"""
from __future__ import annotations

from typing import Any, Callable, List

#: called with (op name, arguments, outputs) at each launch
observers: List[Callable[[str, tuple, Any], None]] = []


def launched(op: str, args: tuple, outputs: Any) -> None:
    for observe in observers:
        observe(op, args, outputs)
