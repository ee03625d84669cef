"""Commitment schemes: Dory (`dory`) and HyperKZG (`hyperkzg`), behind the
scheme seam (`scheme`)."""
