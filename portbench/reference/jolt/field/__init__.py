from .params import FR
