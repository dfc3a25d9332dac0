"""Block access tokens, as a client reads them.

The client's part of ``hadoop_tpu/dfs/protocol/blocktoken.py``: when
``dfs.block.access.token.enable`` is on, the NameNode mints an HMAC
token binding (user, block id, access modes, expiry) into every
``LocatedBlock`` it serves, and DataNodes refuse a data-plane op or a
short-circuit fd grant without one. The client only carries the token
(a ``Token.to_wire()`` dict, ``LocatedBlock.token``) in its op frames;
a striped file's units read with their group's token.
``BlockTokenSecretManager`` mints on the NameNode and checks on the
DataNodes, which hold only the NameNode's exported master keys.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from hadoop_tpu_torch.security.ugi import (AccessControlError,
                                           SecretManager, Token)

KIND = "HTPU_BLOCK_TOKEN"

MODE_READ = "read"
MODE_WRITE = "write"
MODE_COPY = "copy"


class BlockTokenSecretManager(SecretManager):
    """NN side mints; DN side verifies with imported keys."""

    def __init__(self, key_rotation_s: float = 10 * 3600.0,
                 token_ttl_s: float = 10 * 3600.0):
        super().__init__(KIND, key_rotation_s=key_rotation_s,
                         token_ttl_s=token_ttl_s)

    # ------------------------------------------------------------- NN side

    def generate_token(self, user: str, block_id: int,
                       modes: Sequence[str] = (MODE_READ,)) -> Dict:
        """Wire-ready token granting ``user`` the listed modes on one
        block (ref: BlockTokenSecretManager.generateToken)."""
        return self.create_token(user, extra={
            "block": block_id, "modes": list(modes)}).to_wire()

    def export_keys(self) -> List[Dict]:
        """Master keys for verifying DNs (ref: exportKeys handing
        ExportedBlockKeys to DNs via DatanodeProtocol.registerDatanode/
        heartbeat)."""
        with self._lock:
            return [{"id": kid, "key": key}
                    for kid, key in self._keys.items()]

    # ------------------------------------------------------------- DN side

    @classmethod
    def for_verification(cls) -> "BlockTokenSecretManager":
        """A DN-side instance that can only verify: it discards its own
        minted key and waits for the NN's."""
        mgr = cls()
        with mgr._lock:
            mgr._keys.clear()
        return mgr

    def import_keys(self, keys: List[Dict]) -> None:
        with self._lock:
            self._keys = {k["id"]: k["key"] for k in keys}
            # Mint with the exporter's newest key: this instance's own
            # counter is meaningless after the swap, and would KeyError
            # in create_token once the exporter rotates past it (the
            # balancer mints from imported keys the same way DNs do for
            # transfers — ref: BlockTokenSecretManager.setKeys updating
            # currentKey on the non-master side).
            if self._keys:
                self._key_id = max(self._keys)

    def check_access(self, token_wire: Dict, block_id: int,
                     mode: str) -> Dict:
        """Verify signature/expiry AND that the token names this block
        with this mode (ref: BlockTokenSecretManager.checkAccess).
        Returns the identifier; raises AccessControlError."""
        if not isinstance(token_wire, dict):
            raise AccessControlError("block access token required")
        try:
            ident = self.verify_token(Token.from_wire(token_wire))
        except AccessControlError:
            raise
        except Exception as e:  # malformed wire shape, bad ident bytes
            raise AccessControlError(f"malformed block token: {e}") from e
        extra = ident.get("extra") or {}
        if extra.get("block") != block_id:
            raise AccessControlError(
                f"token is for block {extra.get('block')}, not {block_id}")
        if mode not in (extra.get("modes") or []):
            raise AccessControlError(
                f"token does not grant {mode!r} on block {block_id}")
        return ident
