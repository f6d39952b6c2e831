from .mesh import (Mesh, Sharded, contract_pieces, device_bytes, make_mesh,
                   shard_blocks, shard_df, shard_hamiltonian, shard_hbar,
                   shard_pair_stacks, take)

__all__ = ["Mesh", "Sharded", "make_mesh", "shard_hamiltonian",
           "shard_blocks", "shard_df", "shard_hbar", "shard_pair_stacks",
           "contract_pieces", "take", "device_bytes"]
