"""Offline Edits Viewer entry point (see hadoop_tpu_torch.cli.oiv
.dump_edits; the port's copy of ``hadoop_tpu/cli/oev.py``; ref:
tools/offlineEditsViewer/OfflineEditsViewer.java)."""

import sys

from hadoop_tpu_torch.cli.oiv import main_oev

if __name__ == "__main__":
    sys.exit(main_oev())
