"""Distribution (the JAX package's dist/): robot groups over
torch.distributed, bulk-synchronous RBCD rounds, fault masks,
checkpoints, the sequence-parallel chain solver, the split hypothesis
table and the inter-process TCP fabric of the pod tier."""
