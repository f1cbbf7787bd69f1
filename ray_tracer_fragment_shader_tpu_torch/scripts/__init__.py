"""The scripts that define the port's cells, the counterparts of the JAX
package's ``scripts/`` of the same names: ``depth_sweep`` (the chain and
fwd+bwd steps at depths 2, 3 and 5, the bounce tree at 2-4),
``bench_reference_demo`` (the reference's own 500^2 depth-5 16-sample
adaptive frame) and ``make_fit_demo`` (the multi-view config-4 recipe end
to end).  Each runs on the card unless given ``--device cpu`` and writes
under ``chiprun_out/``:

    python -m ray_tracer_fragment_shader_tpu_torch.scripts.depth_sweep
"""
