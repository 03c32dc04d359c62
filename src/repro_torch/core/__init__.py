"""Episodic task containers, FiLM, the set encoder, the LITE serve
estimators and the meta-learners."""
