"""Host utilities: CRC32C checksums (``crc``) for the DFS client, and the
daemon threads, address lists and retry backoff the fleet daemons share
(``misc``)."""
