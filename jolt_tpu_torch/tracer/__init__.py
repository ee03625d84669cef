from .trace import Trace, trace_program, TRACE_FIELDS
