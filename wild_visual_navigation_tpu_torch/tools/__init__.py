"""The offline tools of the port, each run as
`python -m wild_visual_navigation_tpu_torch.tools.<name>` (port of the
repository's root tools/ that drive the JAX package):

  param_search       the vectorised hyperparameter search (torch.func.vmap)
  generate_dataset   image folder -> per-image graph records
  ablation_sweep     feature x segmentation ablation: online replay, export,
                     k-fold offline training beside a label-shuffle control
  real_data_eval     training and evaluation on the reference's recorded graph
  soak               long-horizon run of the online loop with its gates

Every tool takes `--device` (the card by default; `cpu` runs it here).
"""
