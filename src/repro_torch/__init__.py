"""``repro_torch`` — the PyTorch/CUDA port of the black-box performance
modeller, beside the JAX package ``repro`` it is checked against.

The slice ported so far is the paper's core loop on an NVIDIA H100:
time the UIPiCK battery on the card (:mod:`repro_torch.core.uipick`),
count each kernel's features at the aten level
(:mod:`repro_torch.core.counting`), fit the ``p_* × f_*`` models by
Levenberg-Marquardt (:mod:`repro_torch.core.calibrate`), save a
reference-schema :class:`~repro_torch.profiles.MachineProfile`, and
predict the §8 hand kernels (:mod:`repro_torch.kernels.ops`) from it with
zero timings (:mod:`repro_torch.api`).

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``"cpu"``; without a card they raise instead of falling back.
"""
