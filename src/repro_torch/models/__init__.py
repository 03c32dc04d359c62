"""Feature extractors for the episodic learners."""
