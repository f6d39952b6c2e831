from .mesh import (Mesh, Sharded, device_bytes, make_mesh, shard_blocks,
                   shard_df, shard_hamiltonian, shard_hbar)

__all__ = ["Mesh", "Sharded", "make_mesh", "shard_hamiltonian",
           "shard_blocks", "shard_df", "shard_hbar", "device_bytes"]
