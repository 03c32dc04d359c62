"""Host-side (numpy) episodic task sources and collation."""
