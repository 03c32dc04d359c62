"""Single-device training runtime: the episodic step adapter, checkpoints,
the batch prefetcher and the fault-tolerant loop."""
