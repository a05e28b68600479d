"""The OFA prompted-graph path (counterpart of ``stemgnn_tpu/ofa``):
k-hop subgraphs, prompt assembly, the runtime datasets, few-shot episodes,
multi-dataset mixing, the task constructor, the class-node scoring heads
and the in-context / few-shot training loops."""
