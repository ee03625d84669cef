from . import flags
from .r1cs_inputs import R1CSCycleInputs, extract_r1cs_inputs
