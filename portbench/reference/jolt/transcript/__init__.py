from .blake2b import Blake2bTranscript
