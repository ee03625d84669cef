"""Commitment schemes: Dory (`dory`, `scheme`) and the HyperKZG proof type
of the proof format (the scheme is ROADMAP A15)."""

from .dory import Dory, DoryCommitment, DoryProof, DorySetup
from .scheme import DoryScheme, make_scheme
