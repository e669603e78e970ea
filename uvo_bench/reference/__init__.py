"""The plain reference that decides a run's ``correct``.

A frozen copy of the port's arithmetic on the benchmark's paths (SURF
preprocessing, detection and description, matching, the mono relative pose,
the stereo PnP, triangulation and their gates), in plain PyTorch: the
top-2 distances and the Jacobi eigensolver are the plain versions of the
port's two CUDA kernels.  It imports nothing of ``ergo_uvo_tpu_torch``, of
``ergo_uvo_tpu`` or of JAX, and takes nothing the port made: it builds its
own preprocessing plan and draws its own minimal sets from a generator at
the position the port's was.
"""
