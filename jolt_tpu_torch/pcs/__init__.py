"""Commitment-scheme types of the proof format (the schemes themselves
come with Dory, ROADMAP A11)."""
