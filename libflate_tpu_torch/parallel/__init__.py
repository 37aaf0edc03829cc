"""Scale-out of the port (counterpart of ``libflate_tpu/parallel/``).

* :mod:`.mesh`: a one-axis mesh of torch devices (``blocks``), and how a
  batch's leading axis lies on it;
* :mod:`.sharding`: the block encode, member decode, shared-table sync
  encode and sync decode with the batch split over a mesh, and the
  cross-shard CRC fold;
* :mod:`.multihost`: PGZF encode, decode and corpus CRC split over the
  processes of a ``torch.distributed`` group, one slab of members each.
"""
