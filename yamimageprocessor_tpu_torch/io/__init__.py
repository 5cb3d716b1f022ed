"""On-disk image records for the streaming runtime."""
