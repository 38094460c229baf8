"""Format registry, result contract and element-wise codecs (torch)."""
