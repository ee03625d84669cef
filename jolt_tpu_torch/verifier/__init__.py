from .verifier import PublicIO, VerificationError, verify_prefix
