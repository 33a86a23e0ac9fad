"""MOCAP chunked-pipeline prefill in PyTorch, with hand-written CUDA kernels
for Hopper (sm_90a).

A port of ``src/repro`` (JAX + Pallas), which stays the reference. The
module layout mirrors the reference: ``repro_torch.core.pipeline`` is the
counterpart of ``repro.core.pipeline`` and so on. The port imports torch and
numpy only; the N pipeline stages run on one GPU as a leading tensor axis.
"""
