"""Dynamics kernels: int8 synchronous steps and the bit-packed rollout."""
