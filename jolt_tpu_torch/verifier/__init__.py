from .verifier import PublicIO, VerificationError, verify_stage1
