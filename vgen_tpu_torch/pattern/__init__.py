from vgen_tpu_torch.pattern.pattern import DeviceDFA, Pattern
from vgen_tpu_torch.pattern.redfa import DFA, RegexError, compile_dfa

__all__ = ["Pattern", "DeviceDFA", "DFA", "RegexError", "compile_dfa"]
