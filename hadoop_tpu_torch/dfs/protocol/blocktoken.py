"""Block access tokens, as a client reads them.

The client's part of ``hadoop_tpu/dfs/protocol/blocktoken.py``: when
``dfs.block.access.token.enable`` is on, the NameNode mints an HMAC
token binding (user, block id, access modes, expiry) into every
``LocatedBlock`` it serves, and DataNodes refuse a data-plane op or a
short-circuit fd grant without one. The client only carries the token
(a ``Token.to_wire()`` dict, ``LocatedBlock.token``) in its op frames;
a striped file's units read with their group's token. Minting
(``BlockTokenSecretManager``) and checking stay the daemons'.
"""

from __future__ import annotations

KIND = "HTPU_BLOCK_TOKEN"

MODE_READ = "read"
MODE_WRITE = "write"
MODE_COPY = "copy"
