"""Consistency models and their memoized (tensor-ready) form."""

from .model import (
    Model, Register, CASRegister, CASRegisterComdb2, Mutex, MultiRegister,
    GSet, UnorderedQueue, FIFOQueue, step,
    register, cas_register, cas_register_comdb2, mutex, multi_register,
    set_model, unordered_queue, fifo_queue, MODELS,
)
from .memo import IncrementalMemo, MemoizedModel, MemoOverflow, memo, \
    memoize_model, transitions_of

__all__ = [
    "Model", "Register", "CASRegister", "CASRegisterComdb2", "Mutex",
    "MultiRegister", "GSet", "UnorderedQueue", "FIFOQueue", "step",
    "register", "cas_register", "cas_register_comdb2", "mutex",
    "multi_register", "set_model", "unordered_queue", "fifo_queue",
    "MODELS", "IncrementalMemo", "MemoizedModel", "MemoOverflow", "memo", "memoize_model",
    "transitions_of",
]
