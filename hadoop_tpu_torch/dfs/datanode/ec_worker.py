"""Erasure-coding reconstruction worker for the DataNode.

The port's copy of ``hadoop_tpu/dfs/datanode/ec_worker.py``, on the same
wire and disk formats.

Parity with the reference's DN-side EC machinery (ref:
server/datanode/erasurecode/ErasureCodingWorker.java:47,
StripedBlockReconstructor.java:34, StripedReader/StripedWriter): given an
EC_RECONSTRUCT command, read the stripe cells of k surviving units from
peer DataNodes, decode the missing unit with the policy's raw coder, and
store it as a local finalized replica (reported back to the NameNode via
the normal incremental block report).

Reconstruction proceeds stripe-run by stripe-run (``SPAN_CELLS`` cells
per source read) so memory stays bounded regardless of block size.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo
from hadoop_tpu_torch.io import erasurecode as ec
from hadoop_tpu_torch.util.crc import DataChecksum

log = logging.getLogger(__name__)

SPAN_CELLS = 64  # cells fetched per source round (64 × 64 KB = 4 MB)


def fetch_range(addr: Tuple[str, int], block: Block, offset: int,
                length: int, security=None, block_tokens=None) -> bytes:
    """Read [offset, offset+length) of a remote replica (OP_READ_BLOCK).
    A reconstructing DN mints its own READ token from the shared keys
    (ref: the reconstruction worker's datanode-issued tokens)."""
    token = None
    if block_tokens is not None:
        from hadoop_tpu_torch.dfs.protocol import blocktoken as bt
        token = block_tokens.generate_token("datanode", block.block_id,
                                            (bt.MODE_READ,))
    return dt.read_block_range(addr, block.to_wire(), offset, length,
                               security=security, token=token)


def reconstruct(store, payload: Dict, security=None,
                block_tokens=None) -> Optional[Block]:
    """Execute one EC_RECONSTRUCT command; returns the rebuilt unit block
    (for the incremental report) or None on failure."""
    group = Block.from_wire(payload["group"])
    policy = ec.get_policy(payload["policy"])
    missing_idx: int = payload["idx"]
    sources: List[Tuple[DatanodeInfo, int]] = [
        (DatanodeInfo.from_wire(w), idx) for w, idx in payload["sources"]]

    k, cell = policy.k, policy.cell_size
    target_len = ec.unit_length(group.num_bytes, policy, missing_idx)
    unit = Block(group.block_id + missing_idx, group.gen_stamp, target_len)

    # Pick k sources, preferring data units (cheaper decode is not a thing
    # for RS, but data-unit lengths define the stripe widths).
    sources = sorted(sources, key=lambda s: s[1])[:policy.num_units]
    by_idx = {idx: info for info, idx in sources}

    checksum = DataChecksum(dt.CHUNK_SIZE)
    open_rep = store.create_rbw(unit, checksum)
    try:
        built = 0
        stripe = 0
        while built < target_len:
            # One span: SPAN_CELLS stripes' worth of cells per source.
            span_shards: List[Optional[bytes]] = [None] * policy.num_units
            got = 0
            span_stripes = SPAN_CELLS
            for idx in range(policy.num_units):
                if got >= k:
                    break
                if idx == missing_idx or idx not in by_idx:
                    continue
                src_len = ec.unit_length(group.num_bytes, policy, idx)
                off = stripe * cell
                want = min(span_stripes * cell, max(0, src_len - off))
                blk = Block(group.block_id + idx, group.gen_stamp, src_len)
                try:
                    raw = fetch_range(by_idx[idx].xfer_addr(), blk, off,
                                      want, security=security,
                                      block_tokens=block_tokens)
                except (OSError, EOFError, IOError) as e:
                    log.warning("EC source unit %d unreadable: %s", idx, e)
                    continue
                span_shards[idx] = raw
                got += 1
            if got < k:
                raise IOError(f"only {got} of {k} EC sources readable")
            # Decode stripe by stripe within the span.
            for s in range(span_stripes):
                if built >= target_len:
                    break
                widths = [
                    max(0, min(group.num_bytes
                               - ((stripe + s) * k + i) * cell, cell))
                    for i in range(k)]
                width = max(widths)
                if width == 0:
                    break
                shards: List[Optional[bytes]] = [None] * policy.num_units
                for idx, span in enumerate(span_shards):
                    if span is None:
                        continue
                    frag = span[s * cell:s * cell + width]
                    if len(frag) < width:
                        frag = frag + b"\0" * (width - len(frag))
                    shards[idx] = frag
                full = policy.new_coder().decode(shards)
                want_w = widths[missing_idx] if missing_idx < k else width
                piece = full[missing_idx][:want_w]
                piece = piece[:target_len - built]
                if piece:
                    open_rep.write_packet(piece,
                                          checksum.checksums_for(piece))
                    built += len(piece)
            stripe += span_stripes
        rep = store.finalize(open_rep)
        log.info("Reconstructed EC unit %s (%d bytes)", unit, built)
        return rep.to_block()
    except Exception as e:  # noqa: BLE001 — report and let NN reschedule
        log.warning("EC reconstruction of %s failed: %s", unit, e)
        try:
            open_rep.abort()
        except (OSError, IOError) as e2:
            log.debug("EC replica abort failed: %s", e2)
        return None
