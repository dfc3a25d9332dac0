"""Host utilities the DFS client needs: CRC32C checksums (``crc``)."""
