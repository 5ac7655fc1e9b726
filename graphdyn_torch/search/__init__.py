"""Search drivers (the port of ``graphdyn/search``): the fused one-kernel
annealer."""
