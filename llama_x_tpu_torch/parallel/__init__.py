"""Data and context parallelism over ``torch.distributed`` (port of llama_x_tpu/parallel):
the mesh (``mesh.py``), the batch split (``sharding.py``), ring attention over the cp axis
(``context.py`` over ``ops/ring_attention.py``) and Ulysses (``ulysses.py``)."""
