"""Commitment schemes: Dory (`dory`) and HyperKZG (`hyperkzg`), behind the
scheme seam (`scheme`)."""

from .dory import Dory, DoryCommitment, DoryProof, DorySetup
from .hyperkzg import HyperKZG, HyperKZGProof, KZGSetup
from .scheme import DoryScheme, HyperKZGScheme, make_scheme
