"""Hand-written Hopper kernels (``csrc/``), their torch wrappers, the
model-layout adapters (``ops``) and the plain torch oracles (``ref``)."""
