"""The NameNode's web UI: human-readable status over its HTTP server.

The port's copy of the NameNode page of ``hadoop_tpu/http/webui.py``
(``/dfshealth``); the ResourceManager's page comes with the YARN daemons
(ROADMAP Queue A 11).

Parity-in-kind with the reference's webapps (ref: the RM's yarn-ui /
webapp cluster pages and the NN's dfshealth.html): not the React
application, but the operational signal those pages exist for — one
server-rendered HTML page per daemon showing the same numbers the
JSON endpoints serve, so a person with a browser (or curl) can see
cluster state without tooling. Zero dependencies; the tables render
from the daemons' live structures on each request.
"""

from __future__ import annotations

import html
import time
from typing import Dict, Iterable, List, Tuple

_STYLE = """
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem; color: #222; }
 h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 1.5rem; }
 table { border-collapse: collapse; margin-top: .5rem; }
 th, td { border: 1px solid #ccc; padding: .25rem .6rem;
          font-size: .85rem; text-align: left; }
 th { background: #f2f2f2; }
 .num { text-align: right; font-variant-numeric: tabular-nums; }
 .ok { color: #0a7d32; } .bad { color: #b00020; }
 footer { margin-top: 2rem; color: #888; font-size: .75rem; }
</style>
"""


def _esc(v) -> str:
    return html.escape(str(v))


def _table(headers: List[str], rows: Iterable[List]) -> str:
    out = ["<table><tr>"]
    out += [f"<th>{_esc(h)}</th>" for h in headers]
    out.append("</tr>")
    for row in rows:
        out.append("<tr>")
        out += [f"<td>{_esc(c)}</td>" for c in row]
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _page(title: str, body: str) -> Tuple[int, str, Dict[str, str]]:
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{_esc(title)}</title>{_STYLE}</head><body>"
           f"<h1>{_esc(title)}</h1>{body}"
           f"<footer>rendered {time.strftime('%Y-%m-%d %H:%M:%S')} — "
           f"hadoop_tpu</footer></body></html>")
    return 200, doc, {"Content-Type": "text/html; charset=utf-8"}


# ----------------------------------------------------------------- YARN RM

def nn_dfshealth_page(nn):
    """GET /dfshealth on the NN (ref: dfshealth.html — the overview +
    datanode table operators live in)."""
    def handler(query, body):
        fsn = nn.fsn
        stats = {
            "files": fsn.fsdir.num_inodes(),
            "blocks": fsn.bm.num_blocks(),
            "under_replicated": fsn.bm.under_replicated_count(),
            "safemode": fsn.bm.safemode.is_on(),
            "state": nn.ha_state,
        }
        summary = _table(
            ["HA state", "files", "blocks", "under-replicated",
             "safemode"],
            [[stats["state"], stats["files"], stats["blocks"],
              stats["under_replicated"],
              "ON" if stats["safemode"] else "off"]])
        dns = []
        for node in fsn.bm.dn_manager.all_nodes():
            pct = (100.0 * node.dfs_used / node.capacity) \
                if node.capacity else 0.0
            dns.append([node.uuid[:12], f"{node.host}:{node.xfer_port}",
                        node.state, f"{node.capacity >> 20} MB",
                        f"{node.dfs_used >> 20} MB", f"{pct:.1f}%",
                        len(node.blocks)])
        body_html = (
            f"<h2>Overview</h2>{summary}"
            f"<h2>Datanodes ({len(dns)})</h2>"
            + _table(["uuid", "address", "state", "capacity", "used",
                      "used%", "blocks"], dns)
            + "<p>JSON: <a href='/fsstatus'>fsstatus</a> · WebHDFS at "
              "<code>/webhdfs/v1</code></p>")
        return _page(f"NameNode {nn.nn_id}", body_html)
    return handler
