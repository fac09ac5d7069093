"""Registry entries for the tree-arithmetic fused ops."""
from __future__ import annotations

from .. import api
from .kernel import launch_add_sub, launch_axpby
from .ref import add_sub_ref, axpby_ref

api.register(
    api.FusedOp(
        name="axpby",
        ref_fn=axpby_ref,
        launch=launch_axpby,
        n_inputs=2,
        n_outputs=1,
        n_scalars=2,
        out_dtype_from=(1,),   # y's dtype (overridable via like=)
        doc="a*x + b*y over whole trees (SGD/momentum/SPA arithmetic)",
    )
)

api.register(
    api.FusedOp(
        name="add_sub",
        ref_fn=add_sub_ref,
        launch=launch_add_sub,
        n_inputs=3,
        n_outputs=1,
        n_scalars=0,
        out_dtype_from=(0,),
        doc="a + b - c over whole trees (gradient-tracking correction)",
    )
)
