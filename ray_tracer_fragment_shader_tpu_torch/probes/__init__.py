"""The card's issue-rate probes, the counterparts of the JAX package's
``scripts/vpu_op_probe.py`` (P1, ``op_probe``), ``scripts/bf16_probe.py``
(P2, ``bf16_probe``), ``scripts/pressure_probe.py`` (P3,
``pressure_probe``) and ``scripts/roofline_validate.py``
(``roofline_validate``).  Each runs on the card only and writes its JSON
under ``chiprun_out/roofline_h100/``:

    python -m ray_tracer_fragment_shader_tpu_torch.probes.op_probe
"""
