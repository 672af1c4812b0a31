"""
The reference's parts that a configuration names, each a flat file of this
directory, found by its name:

- ``isp_<model>.py``: the ISP that ``flow.nip`` names (the model up to any
  ':', lower-cased). It gives ``develop(x, leaves, **nip_args)``, NCHW input
  to RGB, ignoring the program-only arguments it does not model;
  ``load(path, device)`` where the ISP reads a snapshot; ``leaf_shapes(
  **nip_args)`` ({name: shape} under the program's parameter names) where it
  is drawn from the seed; ``IDENTITY = True`` where it develops nothing.
- ``manipulation_<name>.py``: a manipulation outside
  ``manipulations.MANIPULATIONS``, giving ``apply(y, strength)``.
- ``<reference>.py``: the flow that the configuration's ``reference`` names,
  giving ``Flow(config, leaves, fault=None)`` and ``parts(config)``.

A name whose file is missing fails here, with the file's path.
"""
import importlib
import importlib.util

PACKAGE = 'benchmark.reference'


def module(stem, what):
    """``benchmark/reference/<stem>.py``, imported; ``what`` names it in the error."""
    if importlib.util.find_spec(f'{PACKAGE}.{stem}') is None:
        raise FileNotFoundError(f'{what} has no reference: benchmark/reference/{stem}.py '
                                f'is missing')
    return importlib.import_module(f'{PACKAGE}.{stem}')


def isp(nip):
    """The reference ISP of a ``flow.nip`` entry ('INet', 'UNet:<snapshot dir>')."""
    model = nip.split(':')[0]
    return module(f'isp_{model.lower()}', f'the ISP {model!r}')


def manipulation(name):
    return module(f'manipulation_{name}', f'the manipulation {name!r}')


def flow(config):
    """The reference flow module of a configuration's ``reference``."""
    return module(config['reference'], f"the reference flow {config['reference']!r}")
