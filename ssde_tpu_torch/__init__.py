"""ssde_tpu_torch — the PyTorch + CUDA (Hopper) port of ssde_tpu.

It keeps ``ssde_tpu``'s module paths and names, on NCHW tensors, and
replaces each Pallas TPU kernel on its path with a kernel written by hand
for sm_90a (``csrc/``, built at first use by ``ops/build.py``). It imports
no JAX; from ``ssde_tpu`` it uses only the host-side ``config`` and
``eval.depth`` modules.
"""
