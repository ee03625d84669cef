"""A frozen copy of the port's verifier, cut to what the benchmark's
check runs.

The files are those of `jolt_tpu_torch` at commit e0c4691 that
`verifier/verifier.py`, `proof_io.py` and `tracer/trace.py` import, cut to
the definitions the verify path reaches (the prover, its kernels, the
device tier, HyperKZG and the profiler are gone; `proof.py` keeps the
proof containers and constants of `prover/prover.py`).  What else differs:

  * every pairing, GT power and MSM runs on Python ints: no native library
    is built or loaded, and nothing here imports torch;
  * `pcs/dory.py`: the setup cache's unpickler takes this package's
    classes, and `Dory.verify`'s group work (and `DoryScheme.combine`'s)
    runs in forked worker processes while `dory.parallel` holds a pool;
  * `proof_io.py` decodes no HyperKZG proof.

This is NOT an independent implementation: the relations' formulas, the
transcript, the proof codec and the emulator are the port's own, copied.
A fault that the copy shares with the port's prover is invisible to it.
What it does hold fixed: a later change to the port leaves this copy, and
with it what `correct` means, as it is.  Nothing here imports the port or
JAX.
"""
