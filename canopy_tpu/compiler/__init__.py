"""Compiler: MEF model -> level-scheduled sparse array form for the device."""

from .graph import CompiledTree, compile_fault_tree, compile_gates  # noqa: F401
from .expr_tape import ExpressionTape  # noqa: F401
