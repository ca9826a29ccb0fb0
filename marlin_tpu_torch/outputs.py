"""[TensorOutputs] registry (reference AddTensorOutputAction +
src/tensor_outputs/); a copy of marlin_tpu/outputs.py."""

from __future__ import annotations

from .params import Params
from .registry import outputs as output_registry


class OutputError(Exception):
    pass


def build_tensor_outputs(node, problem, output_dir=".", default_file_base=None):
    # ensure the built-in types are registered (decorator at class site)
    from . import xdmf  # noqa: F401

    outs = []
    for b in node.blocks():  # blocks() honors `active =` / `inactive =`
        p = Params(b, problem.global_params)
        t = p.get_str("type", required=True)
        if t not in output_registry:
            # the reference errors on unregistered output types; silent
            # skips would make a mistyped deck write nothing
            raise OutputError(
                f"Unknown [TensorOutputs] type '{t}' (block '{b.name}')")
        outs.append(output_registry.create(
            t, b.name, p, problem, output_dir,
            default_file_base=default_file_base,
        ))
    return outs
