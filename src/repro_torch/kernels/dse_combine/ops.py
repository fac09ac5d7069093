"""Registry entries for the fused dual-slow combine (both state layouts)."""
from __future__ import annotations

from .. import api
from .kernel import launch_dse_combine, launch_dse_combine_yh
from .ref import dse_combine_ref, dse_combine_yh_ref

api.register(
    api.FusedOp(
        name="dse_combine",
        ref_fn=dse_combine_ref,
        launch=launch_dse_combine,
        n_inputs=4,             # params, v, x_ref, z
        n_outputs=2,            # u (SGT pre-mix message), h
        n_scalars=1,            # gamma
        out_dtype_from=(3, 1),  # u: z's dtype, h: v's dtype
        doc="dual-slow combine, fused-z state (Alg. 1 lines 7-9, one pass)",
    )
)

api.register(
    api.FusedOp(
        name="dse_combine_yh",
        ref_fn=dse_combine_yh_ref,
        launch=launch_dse_combine_yh,
        n_inputs=5,             # params, v, x_ref, y, h_prev
        n_outputs=2,
        n_scalars=1,
        out_dtype_from=(3, 1),  # u: y's dtype, h: v's dtype
        doc="dual-slow combine, (y, h_prev) state (Alg. 1 lines 7-9, one pass)",
    )
)
