from .verifier import PublicIO, VerificationError, verify, verify_prefix
