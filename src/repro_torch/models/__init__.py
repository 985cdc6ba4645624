"""The language models of the reference (``repro.models``), in PyTorch:
prefill and train attention, the Mamba-2 scan and the sLSTM recurrence
run the hand kernels on the card (``repro_torch.kernels.ops``)."""
