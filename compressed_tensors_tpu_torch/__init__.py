"""compressed_tensors_tpu_torch: the PyTorch/CUDA port of
compressed_tensors_tpu for NVIDIA Hopper.

It reads and runs compressed-tensors checkpoints run compressed, with
hand-written CUDA kernels for the hot paths (``ops/kernels/``, sources in
``csrc/``). Entry points run on the card unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs instead.
"""
