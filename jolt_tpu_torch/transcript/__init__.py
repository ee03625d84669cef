from .blake2b import Blake2bTranscript
from .keccak import KeccakTranscript
from .poseidon import PoseidonTranscript
