from .constraints import (EQ_CONSTRAINTS, PRODUCT_CONSTRAINTS, NUM_CONSTRAINTS,
                          PADDED_CONSTRAINTS, LOG_PADDED_CONSTRAINTS,
                          eval_az_bz_cz_int, check_satisfied)
