from .registry import (JoltBackend, SLOTS, default_backend, get_backend,
                       set_backend)

__all__ = ["JoltBackend", "SLOTS", "default_backend", "get_backend",
           "set_backend"]
