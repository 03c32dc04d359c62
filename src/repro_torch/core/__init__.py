"""Episodic task containers, FiLM, the set encoder, the LITE estimators, the
meta-learners and the task-batched meta-train step."""
