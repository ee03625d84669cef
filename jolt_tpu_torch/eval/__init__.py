from .fuzz import (check_invariants, gen_program, run_differential,
                   run_fuzz_case)

__all__ = ["gen_program", "run_differential", "check_invariants",
           "run_fuzz_case"]
