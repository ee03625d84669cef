from . import dense, eq
from .univariate import UniPoly
