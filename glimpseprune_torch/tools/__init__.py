"""The port's command lines, run as ``python -m glimpseprune_torch.tools.<name>``:
``train_gp``, ``infer_viscot``, ``score_results`` and ``demo``
(counterparts of the repo's tools/ scripts of the same names). Each has
``main(argv=None)``, so it can also be called in process."""
