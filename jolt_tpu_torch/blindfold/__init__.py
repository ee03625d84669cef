"""Proof-format types of the zk mode (the mode itself is ROADMAP A14)."""
