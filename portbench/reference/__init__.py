"""Plain PyTorch reference of what the benchmark's cells run: the Neural
Laplace forward (``nl``), one delay-aware MPPI tick (``mppi``) and the
environments (``cartpole``). It imports torch and the standard library only:
nothing of the port, of JAX or of the JAX package. It takes the checkpoint's
arrays and the benchmark's inputs, never anything the port has made.
"""
