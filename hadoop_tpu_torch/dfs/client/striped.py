"""Striped (erasure-coded) client streams.

The port's copy of ``hadoop_tpu/dfs/client/striped.py``. Write: the
stream buffers one stripe row (k cells of the policy's cell size),
computes the m parity cells on the host with the port's numpy coder
(``io/erasurecode.py``, bit for bit the reference's parity) and sends
cell-sized packets to the k+m unit writers, each a single-target block
write; up to m unit writers may fail mid-group and the group still
completes (the NameNode reconstructs the lost units). Read: a logical
offset maps to (stripe, cell column); a read goes straight to the data
unit, and a missing or corrupt unit turns into a decode read that
fetches the stripe's cells from any k live units and rebuilds the
wanted one. Units read with their group's block token.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set

from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import (Block, DatanodeInfo,
                                                   LocatedBlock)
from hadoop_tpu_torch.io import erasurecode as ec
from hadoop_tpu_torch.util.crc import ChecksumError, DataChecksum

log = logging.getLogger(__name__)


class _UnitWriter:
    """One storage unit's write connection: a single-target block write.
    Ref: StripedDataStreamer — a DataStreamer with no mirror chain.

    The terminal DN acks every packet inline in its receive loop, so acks
    must be consumed as the write progresses — ``send_cell`` drains any
    already-arrived acks non-blockingly; letting them pile up until
    ``finish`` would eventually fill both socket buffers and deadlock the
    DN mid-block on large units."""

    def __init__(self, unit_block: Block, target: DatanodeInfo,
                 checksum: DataChecksum, token=None):
        self.block = unit_block
        self.target = target
        self.checksum = checksum
        self.seq = 0
        self.pos = 0
        self.sock = dt.connect(target.xfer_addr(), timeout=10.0)
        dt.send_frame(self.sock, {
            "op": dt.OP_WRITE_BLOCK, "b": unit_block.to_wire(),
            "targets": [], "stage": dt.STAGE_PIPELINE_SETUP_CREATE,
            "bpc": checksum.bytes_per_chunk, "tok": token,
        })
        setup = dt.recv_frame(self.sock)
        if not setup.get("ok"):
            raise IOError(setup.get("em", "unit writer setup failed"))

    def _check_ack(self, ack: Dict) -> None:
        if any(s != dt.STATUS_SUCCESS for s in ack.get("statuses", [])):
            raise IOError(f"unit write ack failure: {ack}")

    def _drain_ready_acks(self) -> None:
        import select
        # poll: select() takes no descriptor past 1024 (ROADMAP C 29)
        poller = select.poll()
        poller.register(self.sock, select.POLLIN)
        while poller.poll(0):
            self._check_ack(dt.recv_frame(self.sock))

    def send_cell(self, data: bytes) -> None:
        self._drain_ready_acks()
        sums = self.checksum.checksums_for(data)
        dt.send_frame(self.sock, {"seq": self.seq, "off": self.pos,
                                  "data": data, "sums": sums, "last": False})
        self.seq += 1
        self.pos += len(data)

    def finish(self) -> None:
        """Send trailing packet, block until the last ack arrives."""
        dt.send_frame(self.sock, {"seq": self.seq, "off": self.pos,
                                  "data": b"", "sums": b"", "last": True})
        while True:
            ack = dt.recv_frame(self.sock)
            self._check_ack(ack)
            if ack.get("last"):
                return

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class DFSStripedOutputStream:
    """Ref: DFSStripedOutputStream.java. Created by DFSClient.create for
    paths under an EC-policy directory."""

    def __init__(self, client, path: str, policy_name: str):
        self.client = client
        self.path = path
        self.policy = ec.get_policy(policy_name)
        self.coder = self.policy.new_coder()
        self.checksum = DataChecksum(dt.CHUNK_SIZE)
        self._buf = bytearray()      # pending bytes of the current stripe row
        self._pos = 0                # logical bytes written
        self._group_pos = 0          # logical bytes in the current group
        self._group_size = None      # k * block_size (logical bytes/group)
        self._current: Optional[Block] = None
        self._writers: List[Optional[_UnitWriter]] = []
        self._closed = False

    # --------------------------------------------------------------- writes

    def write(self, data: bytes) -> int:
        if self._closed:
            raise ValueError("stream closed")
        stripe_bytes = self.policy.k * self.policy.cell_size
        self._buf += data
        while len(self._buf) >= stripe_bytes:
            row = bytes(self._buf[:stripe_bytes])
            del self._buf[:stripe_bytes]
            self._write_stripe(row)
        return len(data)

    def _write_stripe(self, row: bytes) -> None:
        if self._writers == []:
            self._start_group()
        cell = self.policy.cell_size
        k = self.policy.k
        data_cells = [row[i * cell:(i + 1) * cell] for i in range(k)]
        if len(data_cells[0]) == 0:
            return
        padded = ec.pad_stripe_cells(data_cells)
        parity = self.coder.encode(padded)
        for i, w in enumerate(self._writers):
            if w is None:
                continue
            # Parity cells go out at stripe width; data cells carry only
            # real bytes (an empty tail cell sends nothing).
            payload = data_cells[i] if i < k else parity[i - k]
            if not payload:
                continue
            try:
                w.send_cell(payload)
            except (OSError, IOError) as e:
                log.warning("unit %d writer for %s failed: %s", i,
                            self._current, e)
                w.close()
                self._writers[i] = None
        if sum(1 for w in self._writers if w is not None) < k:
            raise IOError(
                f"too many failed unit writers for {self.path} "
                f"(<{k} of {self.policy.num_units} healthy)")
        self._group_pos += len(row)
        self._pos += len(row)
        if self._group_pos >= self._group_size:
            self._finish_group()

    # ----------------------------------------------------- group lifecycle

    def _start_group(self) -> None:
        lb = self.client.allocate_block(self.path,
                                        self._current.to_wire()
                                        if self._current else None, [])
        if self._group_size is None:
            self._group_size = (self.client.block_size_for(self.path)
                                * self.policy.k)
        by_index: Dict[int, DatanodeInfo] = {}
        for loc, idx in zip(lb.locations, lb.indices or []):
            by_index[idx] = loc
        self._writers = []
        for i in range(self.policy.num_units):
            target = by_index.get(i)
            if target is None:
                self._writers.append(None)
                continue
            unit = Block(lb.block.block_id + i, lb.block.gen_stamp, 0)
            try:
                self._writers.append(
                    _UnitWriter(unit, target, self.checksum,
                                token=lb.token))
            except (OSError, IOError) as e:
                log.warning("unit %d writer setup failed: %s", i, e)
                self._writers.append(None)
        healthy = sum(1 for w in self._writers if w is not None)
        if healthy < self.policy.k:
            raise IOError(f"cannot open ≥{self.policy.k} unit writers "
                          f"({healthy} healthy)")
        self._current = lb.block
        self._group_pos = 0

    def _finish_group(self) -> None:
        if not self._writers:
            return
        for i, w in enumerate(self._writers):
            if w is None:
                continue
            try:
                w.finish()
            except (OSError, IOError) as e:
                log.warning("unit %d finish failed: %s", i, e)
                self._writers[i] = None
            finally:
                w.close()
        if sum(1 for w in self._writers if w is not None) < self.policy.k:
            raise IOError(f"group {self._current} lost >m units at close")
        self._current.num_bytes = self._group_pos
        self._writers = []

    # ---------------------------------------------------------------- close

    def flush(self) -> None:
        pass  # stripes flush on row boundaries; close() drains the tail

    def close(self) -> None:
        if self._closed:
            return
        stripe_bytes = self.policy.k * self.policy.cell_size
        while self._buf:
            row = bytes(self._buf[:stripe_bytes])
            del self._buf[:stripe_bytes]
            self._write_stripe(row)
        self._finish_group()
        self.client.complete_file(
            self.path, self._current.to_wire() if self._current else None)
        self._closed = True

    def tell(self) -> int:
        return self._pos

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        return False


class DFSStripedInputStream:
    """Ref: DFSStripedInputStream.java + StripeReader.java."""

    def __init__(self, client, path: str, info: Optional[Dict] = None):
        self.client = client
        self.path = path
        self._pos = 0
        self._closed = False
        self._dead: Set[str] = set()
        if info is None:
            self._refresh_locations()
        else:
            self._set_locations(info)

    def _refresh_locations(self) -> None:
        self._set_locations(self.client.get_block_locations(self.path))

    def _set_locations(self, info: Dict) -> None:
        self.length = info["length"]
        self.blocks = [LocatedBlock.from_wire(b) for b in info["blocks"]]

    # ---------------------------------------------------------------- reads

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("stream closed")
        if n < 0:
            n = self.length - self._pos
        out = bytearray()
        while n > 0 and self._pos < self.length:
            chunk = self._fetch(self._pos, n)
            if not chunk:
                break
            out += chunk
            self._pos += len(chunk)
            n -= len(chunk)
        return bytes(out)

    def pread(self, position: int, length: int) -> bytes:
        out = bytearray()
        pos = position
        remaining = min(length, self.length - position)
        while remaining > 0:
            chunk = self._fetch(pos, remaining)
            if not chunk:
                break
            out += chunk
            pos += len(chunk)
            remaining -= len(chunk)
        return bytes(out)

    def seek(self, pos: int) -> None:
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def _group_for(self, pos: int) -> LocatedBlock:
        for lb in self.blocks:
            if lb.offset <= pos < lb.offset + lb.block.num_bytes:
                return lb
        raise EOFError(f"offset {pos} beyond file length {self.length}")

    def _token_for(self, block: Block):
        """Unit block → its GROUP's access token (the NN mints one per
        group; see xceiver's striped-id token resolution)."""
        bid = block.block_id
        gid = ec.group_id_of(bid) if ec.is_striped_id(bid) else bid
        for lb in self.blocks:
            if lb.block.block_id in (bid, gid):
                return lb.token
        return None

    def _fetch(self, pos: int, want: int) -> bytes:
        """Read up to ``want`` bytes at ``pos``, capped to one cell."""
        lb = self._group_for(pos)
        policy = ec.get_policy(lb.ec_policy)
        cell = policy.cell_size
        k = policy.k
        gpos = pos - lb.offset                  # logical offset in group
        stripe, in_stripe = divmod(gpos, k * cell)
        col, in_cell = divmod(in_stripe, cell)
        # Bytes remaining in this cell and in the group:
        take = min(want, cell - in_cell, lb.block.num_bytes - gpos)
        unit_off = stripe * cell + in_cell      # offset within unit `col`
        loc = self._unit_location(lb, col)
        if loc is not None and loc.uuid not in self._dead:
            try:
                return self._read_unit(loc, lb, policy, col, unit_off, take)
            except ChecksumError:
                unit = Block(lb.block.block_id + col, lb.block.gen_stamp)
                self.client.report_bad_block(unit, loc.uuid)
                self._dead.add(loc.uuid)
            except (OSError, EOFError, IOError) as e:
                log.debug("unit %d read failed (%s); decoding", col, e)
                self._dead.add(loc.uuid)
        return self._decode_fetch(lb, policy, stripe, col, in_cell, take)

    def _unit_location(self, lb: LocatedBlock,
                       idx: int) -> Optional[DatanodeInfo]:
        for loc, i in zip(lb.locations, lb.indices or []):
            if i == idx:
                return loc
        return None

    def _read_unit(self, loc: DatanodeInfo, lb: LocatedBlock,
                   policy: ec.ECPolicy, idx: int, offset: int,
                   length: int) -> bytes:
        unit_len = ec.unit_length(lb.block.num_bytes, policy, idx)
        unit = Block(lb.block.block_id + idx, lb.block.gen_stamp, unit_len)
        return dt.read_block_range(loc.xfer_addr(), unit.to_wire(), offset,
                                   min(length, unit_len - offset),
                                   token=self._token_for(unit))

    def _decode_fetch(self, lb: LocatedBlock, policy: ec.ECPolicy,
                      stripe: int, col: int, in_cell: int,
                      take: int) -> bytes:
        """Rebuild the wanted cell from any k live units of its stripe.
        Ref: StripeReader.readStripe + decode."""
        cell = policy.cell_size
        k = policy.k
        # Cell lengths within this stripe (possibly the partial last one).
        group_len = lb.block.num_bytes
        cells_len = [
            max(0, min(group_len - (stripe * k + i) * cell, cell))
            for i in range(k)]
        width = max(cells_len) if cells_len else 0
        if width == 0:
            return b""
        shards: List[Optional[bytes]] = [None] * policy.num_units
        got = 0
        errors: List[str] = []
        for idx in range(policy.num_units):
            if got >= k:
                break
            if idx == col:
                continue
            loc = self._unit_location(lb, idx)
            if loc is None or loc.uuid in self._dead:
                continue
            want_len = cells_len[idx] if idx < k else width
            try:
                raw = self._read_unit(loc, lb, policy, idx,
                                      stripe * cell, want_len)
                if len(raw) < width:
                    raw = raw + b"\0" * (width - len(raw))
                shards[idx] = raw
                got += 1
            except (OSError, EOFError, IOError, ChecksumError) as e:
                errors.append(f"unit {idx}: {e}")
        if got < k:
            raise IOError(
                f"cannot decode {self.path} stripe {stripe}: only {got} "
                f"of >={k} units readable; errors: {errors}")
        full = policy.new_coder().decode(shards)
        data = full[col][:cells_len[col]] if col < k else full[col]
        return data[in_cell:in_cell + take]

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
