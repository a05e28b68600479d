"""Multi-GPU paths of the port on ``torch.distributed`` (counterpart of
``stemgnn_tpu/parallel``): the rank set-up (``mesh``), the halo partition,
exchange and encoder (``halo``), the halo full-graph node finetune
(``full_graph``), the halo pretrain on a data x edge grid
(``halo_pretrain``) and the data-parallel pretrain (``data_parallel``)."""
