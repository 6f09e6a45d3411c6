"""The declarative expression frontend (usually imported as ``ein``):

    from repro_torch import frontend as ein

    x = ein.tensor("x", "b s a", (4, 128, 256))
    w = ein.tensor("w", "a f", (256, 1024))
    h = ein.einsum("b s a, a f -> b s f", x, w).map("silu")
    prog = ein.Program({"h": h})
    compiled = prog.compile(mesh_axes={"data": 4, "model": 2},
                            cache="plans.json")
    plan, policy = compiled.plan, compiled.policy()

``expr.py`` holds the lazy symbolic-tensor layer (declaration + trace into
the EinGraph IR), ``program.py`` the Program/CompiledProgram lifecycle
(graph → plan → cache).

New fused ops are declared once through the unified OpDef API —
``ein.defop`` (or the ``@ein.op`` decorator): one record bundling the
einsum-style label signature, dense impl, optional accelerator kernel,
VJP rule, comm declaration, and shard-rule binding.  ``ein.opaque`` then
infers shapes/labels from the signature and the DP prices its comm.
"""
from repro_torch.frontend.expr import (Expr, defop, einsum, map_, maximum, op,
                                       opaque, register_opaque, tensor, trace)
from repro_torch.frontend.program import CompiledProgram, LoweredProgram, Program

__all__ = [
    "Expr", "defop", "einsum", "map_", "maximum", "op", "opaque",
    "register_opaque", "tensor", "trace", "Program", "CompiledProgram",
    "LoweredProgram",
]
