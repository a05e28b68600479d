"""The robustness evaluation scripts of the port, each run as ``python -m
stemgnn_tpu_torch.scripts.<name>``: ``degree_shift_ood``,
``homophily_shift_ood``, ``missing_feature``, ``random_edge_drop`` and
``tri_objective`` (counterparts of the repo's ``scripts/*.py`` of the same
names, with the same flags and printed JSON, plus ``--device``)."""
