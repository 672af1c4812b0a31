"""
The kernels' launchers as PyTorch operators, ``torch.ops.neural_imaging_tpu_torch.<name>``.

A launcher is a ctypes call, which neither ``torch.export`` nor a
``TorchDispatchMode`` (``FlopCounterMode``, ``utils/profiling.py``'s byte
counter) can see into. Registered with ``torch.library.custom_op`` for CUDA
tensors, with a fake implementation that gives the outputs' shapes and
types, each launch is one operator in the dispatcher: an exported program
calls it (and so the kernel), and a mode sees it with its inputs. The
dispatch costs a few microseconds of host time a call.

Each operator has a work function, ``work(*input shapes) → (operations,
bytes)`` for one launch, the least that any implementation must do
(``chip_smoke.py`` bounds the kernels by it and ``profiling.step_cost``
counts it). A CPU tensor never reaches an operator: the dispatchers take the
kernels' plain versions there.
"""
import torch
from torch.utils.flop_counter import flop_registry, register_flop_formula

NAMESPACE = 'neural_imaging_tpu_torch'
# name → (operator packet, work function)
OPS = {}


def register(name, launcher, fake, work):
    """Register ``launcher`` (type-annotated, as ``custom_op`` infers its
    schema from the annotations) as ``NAMESPACE::name`` for CUDA tensors with
    the fake implementation ``fake``; returns the operator. A second
    registration of a name (the module loaded again under another name)
    returns the first."""
    if name not in OPS:
        op = torch.library.custom_op(f'{NAMESPACE}::{name}', launcher, mutates_args=(),
                                     device_types='cuda')
        op.register_fake(fake)
        packet = getattr(getattr(torch.ops, NAMESPACE), name)
        if packet not in flop_registry:
            register_flop_formula(packet)(_flop_formula(work))
        OPS[name] = (packet, work)
    return OPS[name][0]


def _flop_formula(work):
    def flops(*shapes, out_shape=None, **kwargs):
        return work(*shapes)[0]
    return flops
