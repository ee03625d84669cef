"""BlindFold: the zk mode's committed sumcheck rounds and the folded proof
of their checks (`prove(zk=True)`), as the JAX package's `blindfold/`."""
