"""Test and load tooling of the port: seeded open-loop workloads
(:mod:`mmlspark_tpu_torch.testing.loadgen`)."""
