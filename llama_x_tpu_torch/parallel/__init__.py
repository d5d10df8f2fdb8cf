"""The parallelism layer over ``torch.distributed`` (port of llama_x_tpu/parallel): the mesh
(``mesh.py``), the sharding rules, ``shard_params`` and the batch split (``sharding.py``), the
collectives GSPMD would insert for fsdp and tp (``tensor.py``), the GPipe pipeline
(``pipeline.py``), ring attention over the cp axis (``context.py`` over
``ops/ring_attention.py``) and Ulysses (``ulysses.py``)."""
