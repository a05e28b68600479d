"""The OFA heritage model zoo (counterpart of ``stemgnn_tpu/zoo``):
relational convs, the GNN stack, the MLP, pooling, the task predictors,
the SSL / ranking losses and the activation resolver."""
