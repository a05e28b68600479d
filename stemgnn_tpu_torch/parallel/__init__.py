"""Multi-GPU paths of the port on ``torch.distributed`` (counterpart of
``stemgnn_tpu/parallel``): the rank set-up (``mesh``), the halo partition,
exchange and encoder (``halo``) and the halo full-graph node finetune
(``full_graph``)."""
