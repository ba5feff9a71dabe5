from .partition import block_partition, morton_partition

__all__ = ["block_partition", "morton_partition"]
