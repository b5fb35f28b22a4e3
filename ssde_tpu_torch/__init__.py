"""ssde_tpu_torch — the PyTorch + CUDA (Hopper) port of ssde_tpu.

It keeps ``ssde_tpu``'s module paths and names, on NCHW tensors, and
replaces each Pallas TPU kernel on its path with a kernel written by hand
for sm_90a (``csrc/``, built at first use by ``ops/build.py``). It imports
no JAX and nothing of ``ssde_tpu``: the host-side code it shares with the
JAX package (``config``, ``eval.depth``, ``data.synthetic``) is copied, and
the tests hold each copy to its original.
"""
