from .tables import TABLES, interleave_bits, uninterleave_bits
