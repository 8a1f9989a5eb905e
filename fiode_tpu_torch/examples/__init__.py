"""The example drivers on the card (counterparts of ``examples/``), each run
as ``python -m fiode_tpu_torch.examples.<name>`` with ``--device`` (default
cuda) and ``--out-dir`` (default ``run_data/torch/<name>``):

  * ``full_workflow``: train or restore, grid, CROWN [+ refinement],
    Lipschitz, AutoAttack, certified ⊆ robust;
  * ``segway_workflow``: the Segway safe controller, trained and certified;
  * ``hybrid_sweep``: the hybrid min(CROWN, exact + Lipschitz) sweep;
  * ``refute_witnesses``: the exact-witness audit of open images;
  * ``refine_workflow``: branch-and-bound refinement of a CROWN sweep;
  * ``refine_lips_workflow``: local refinement of a Lipschitz sweep;
  * ``alpha_crown_demo``: alpha-CROWN on the images plain CROWN fails;
  * ``alpha_probe``: alpha-CROWN's efficacy on sampled violated cells.

Each reads its checkpoint and summaries from ``--run-dir`` and writes only
under ``--out-dir``.  ``examples/refine_accounting.py`` and
``examples/inclusion_check.py`` fold their JSON as they fold the JAX
drivers'.
"""
