"""LiteFlowNet model, its factories and the JAX weight converter."""
