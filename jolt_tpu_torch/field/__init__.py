from .params import FR
from . import ops
