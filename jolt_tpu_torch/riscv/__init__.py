from . import isa
from .assembler import assemble
from .emulator import Emulator, JoltDevice, MemoryLayout, RAM_START_ADDRESS
