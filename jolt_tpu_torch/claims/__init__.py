from .expr import (Add, Challenge, Const, Expr, Mul, Neg, Poly,
                   linear_combination, product)
from .ids import (CommittedPolynomial, OpeningId, SumcheckId,
                  VirtualPolynomial, all_committed)
from .naive import NaiveExprProver, NaiveExprVerifier, sum_over_hypercube
