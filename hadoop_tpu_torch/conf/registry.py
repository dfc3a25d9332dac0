"""Conf-key registry of the port — GENERATED, do not edit by hand.

Regenerate:  ``python -m hadoop_tpu_torch.analysis --write-conf-registry``
Verify:      ``python -m hadoop_tpu_torch.analysis --check-conf-registry``  (tier-1 gate)

Extracted by ``hadoop_tpu_torch/analysis/confscan.py`` from every statically
resolvable ``conf.get*`` call site in ``hadoop_tpu_torch/``. ``KEYS`` maps each
concrete key to its typed-getter type, the defaults read sites pass,
its namespace, whether the hand-written README documents it (the
generated appendices do not count), and the files that read it.
``PATTERNS`` holds dynamic key families as fnmatch globs. ``LEVERS``
(hand-maintained in ``hadoop_tpu_torch/conf/levers.py``, re-exported here)
carries the tunable-lever annotations: type, range, acceptance guard.
"""

from hadoop_tpu_torch.conf.levers import LEVERS  # noqa: F401  (re-export)

ABSENT = "<absent>"    # a read site passes no default
DYNAMIC = "<dynamic>"  # default computed at runtime, not a literal


KEYS = {
    "conf.strict.keys": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'conf',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/conf/__init__.py',
        ),
    },
    "dfs.block.access.token.enable": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.blockreport.interval": {
        "type": 'time',
        "defaults": ('21600.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.blocksize": {
        "type": 'size',
        "defaults": ('134217728',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.bytes-per-checksum": {
        "type": 'size',
        "defaults": ('512',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
        ),
    },
    "dfs.client-write-packet-size": {
        "type": 'size',
        "defaults": ('1048576',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
        ),
    },
    "dfs.client.hedged.read.threadpool.size": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
            'hadoop_tpu_torch/dfs/client/streams.py',
        ),
    },
    "dfs.client.hedged.read.threshold": {
        "type": 'time',
        "defaults": ('0.5',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/streams.py',
        ),
    },
    "dfs.client.observer.reads.enabled": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
        ),
    },
    "dfs.client.read.shortcircuit": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/streams.py',
        ),
    },
    "dfs.client.write.max-packets-in-flight": {
        "type": 'int',
        "defaults": ('64',),
        "namespace": 'dfs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
        ),
    },
    "dfs.client.write.socket.buffer": {
        "type": 'size',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
        ),
    },
    "dfs.cluster.administrators": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.data.transfer.protection": {
        "type": 'str',
        "defaults": ("'privacy'",),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.capacity": {
        "type": 'size',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.data.dir": {
        "type": 'list',
        "defaults": ('<dynamic>',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.directoryscan.interval": {
        "type": 'time',
        "defaults": ('21600.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.drop.cache.behind.writes": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.hostname": {
        "type": 'str',
        "defaults": ("'127.0.0.1'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.http-port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.http.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.max.locked.memory": {
        "type": 'size',
        "defaults": ('67108864',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.scan.period": {
        "type": 'time',
        "defaults": ('10800.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.storage.type": {
        "type": 'str',
        "defaults": ("'DISK'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.synconclose": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.volume-choosing-policy": {
        "type": 'str',
        "defaults": ("'available-space'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.datanode.volumes": {
        "type": 'int',
        "defaults": ('1',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.domain.socket.path": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/client/streams.py',
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
        ),
    },
    "dfs.encrypt.data.transfer": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'dfs',
        "documented": False, "sites": 3,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.encryption.key.provider.uri": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/client/filesystem.py',
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.ha.automatic-failover.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.ha.health-check.interval": {
        "type": 'time',
        "defaults": ('0.5',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.ha.initial-state": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.ha.lease-duration": {
        "type": 'time',
        "defaults": ('4.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.ha.namenode.id": {
        "type": 'str',
        "defaults": ("'nn1'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.ha.tail-edits.period": {
        "type": 'time',
        "defaults": ('0.5',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.heartbeat.interval": {
        "type": 'time',
        "defaults": ('3.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "dfs.journalnode.edits.dir": {
        "type": 'str',
        "defaults": ("'/tmp/htpu-journal'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/qjournal.py',
        ),
    },
    "dfs.journalnode.handler.count": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/qjournal.py',
        ),
    },
    "dfs.journalnode.rpc-port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/qjournal.py',
        ),
    },
    "dfs.lease.hard-limit": {
        "type": 'time',
        "defaults": ('1200.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.lease.soft-limit": {
        "type": 'time',
        "defaults": ('60.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/client/dfsclient.py',
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.namenode.checkpoint.period": {
        "type": 'time',
        "defaults": ('3600.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.checkpoint.txns": {
        "type": 'int',
        "defaults": ('1000000',),
        "namespace": 'dfs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.handler.count": {
        "type": 'int',
        "defaults": ('8',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.heartbeat.recheck-interval": {
        "type": 'time',
        "defaults": ('10.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "dfs.namenode.http-port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.http.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.name.dir": {
        "type": 'str',
        "defaults": ("'/tmp/htpu-name'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.reconstruction.pending.timeout": {
        "type": 'time',
        "defaults": ('30.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "dfs.namenode.redundancy.interval": {
        "type": 'time',
        "defaults": ('3.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.replication.min": {
        "type": 'int',
        "defaults": ('1',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "dfs.namenode.rpc-address": {
        "type": 'str',
        "defaults": ("'127.0.0.1:8020'",),
        "namespace": 'dfs',
        "documented": False, "sites": 3,
        "files": (
            'hadoop_tpu_torch/dfs/client/filesystem.py',
            'hadoop_tpu_torch/dfs/datanode/datanode.py',
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "dfs.namenode.rpc-bind-host": {
        "type": 'str',
        "defaults": ("'127.0.0.1'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.rpc-port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.safemode.extension": {
        "type": 'time',
        "defaults": ('0.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "dfs.namenode.safemode.threshold-pct": {
        "type": 'float',
        "defaults": ('0.999',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "dfs.namenode.scheduler.impl": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.shared.edits.dir": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
        ),
    },
    "dfs.namenode.write-lock-reporting-threshold": {
        "type": 'time',
        "defaults": ('1.0',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.permissions.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.permissions.superusergroup": {
        "type": 'str',
        "defaults": ("'supergroup'",),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.replication": {
        "type": 'int',
        "defaults": ('3',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "dfs.replication.max": {
        "type": 'int',
        "defaults": ('512',),
        "namespace": 'dfs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/blockmanager.py',
        ),
    },
    "elastic.cooldown.polls": {
        "type": 'int',
        "defaults": ('3',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "elastic.dead.windows": {
        "type": 'int',
        "defaults": ('2',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "elastic.demote.windows": {
        "type": 'int',
        "defaults": ('2',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "elastic.enabled": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "elastic.evict.windows": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "elastic.min-dp": {
        "type": 'int',
        "defaults": ('1',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "elastic.poll.steps": {
        "type": 'int',
        "defaults": ('20',),
        "namespace": 'elastic',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/elastic/__init__.py',
        ),
    },
    "fs.defaultFS": {
        "type": 'str',
        "defaults": ("'file:///'",),
        "namespace": 'fs',
        "documented": False, "sites": 2,
        "files": (
            'hadoop_tpu_torch/cli/dfsadmin.py',
        ),
    },
    "hadoop.rpc.protection": {
        "type": 'str',
        "defaults": ("'authentication'",),
        "namespace": 'hadoop',
        "documented": False, "sites": 3,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
            'hadoop_tpu_torch/ipc/client.py',
            'hadoop_tpu_torch/ipc/server.py',
        ),
    },
    "hadoop.security.authentication": {
        "type": 'str',
        "defaults": ("'simple'",),
        "namespace": 'hadoop',
        "documented": False, "sites": 4,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
            'hadoop_tpu_torch/dfs/namenode/namenode.py',
            'hadoop_tpu_torch/ipc/client.py',
            'hadoop_tpu_torch/ipc/server.py',
        ),
    },
    "hadoop.security.client.keytab": {
        "type": 'str',
        "defaults": ('None',),
        "namespace": 'hadoop',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/client.py',
        ),
    },
    "hadoop.security.group.mapping.static.mapping": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'hadoop',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/security/groups.py',
        ),
    },
    "hadoop.security.server.keytab": {
        "type": 'str',
        "defaults": ('None',),
        "namespace": 'hadoop',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/server.py',
        ),
    },
    "ipc.client.connect.timeout": {
        "type": 'time',
        "defaults": ('20.0',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/client.py',
        ),
    },
    "ipc.client.connection.maxidletime": {
        "type": 'time',
        "defaults": ('10.0',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/client.py',
        ),
    },
    "ipc.client.read.timeout": {
        "type": 'time',
        "defaults": ('120.0',),
        "namespace": 'ipc',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/client.py',
        ),
    },
    "ipc.client.rpc-timeout": {
        "type": 'time',
        "defaults": ('60.0',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/client.py',
        ),
    },
    "ipc.decay-scheduler.decay-factor": {
        "type": 'float',
        "defaults": ('0.5',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
    "ipc.decay-scheduler.period": {
        "type": 'time',
        "defaults": ('5.0',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
    "ipc.decay-scheduler.thresholds": {
        "type": 'list',
        "defaults": ('<absent>',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
    "ipc.ping.interval": {
        "type": 'time',
        "defaults": ('10.0',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/client.py',
        ),
    },
    "ipc.server.connection.maxidletime": {
        "type": 'time',
        "defaults": ('120.0',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/server.py',
        ),
    },
    "ipc.server.reuseport": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'ipc',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/server.py',
        ),
    },
    "metrics.prom.exemplars": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'metrics',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/http/server.py',
        ),
    },
    "namenode.audit.enable": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'namenode',
        "documented": True, "sites": 3,
        "files": (
            'hadoop_tpu_torch/dfs/namenode/audit.py',
            'hadoop_tpu_torch/dfs/namenode/fsnamesystem.py',
        ),
    },
    "net.topology.script.file.name": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'net',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/net/topology.py',
        ),
    },
    "net.topology.table": {
        "type": 'list',
        "defaults": ('()',),
        "namespace": 'net',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/net/topology.py',
        ),
    },
    "obs.comm.timing": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/comm.py',
        ),
    },
    "obs.doctor.endpoints": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.interval": {
        "type": 'time',
        "defaults": ('5.0',),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.max-traces": {
        "type": 'int',
        "defaults": ('256',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/assemble.py',
        ),
    },
    "obs.doctor.namenode.http": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.push.namenode": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.registry": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.scrape.timeout": {
        "type": 'time',
        "defaults": ('2.0',),
        "namespace": 'obs',
        "documented": True, "sites": 2,
        "files": (
            'hadoop_tpu_torch/obs/assemble.py',
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.service": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.floor.ms": {
        "type": 'float',
        "defaults": ('1.0',),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.history": {
        "type": 'int',
        "defaults": ('5',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.mad-k": {
        "type": 'float',
        "defaults": ('3.0',),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.min-peers": {
        "type": 'int',
        "defaults": ('3',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.min-windows": {
        "type": 'int',
        "defaults": ('3',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.ratio": {
        "type": 'float',
        "defaults": ('1.5',),
        "namespace": 'obs',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.slow.ttl": {
        "type": 'time',
        "defaults": ('<dynamic>',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.doctor.trainer.service": {
        "type": 'str',
        "defaults": ("'/trainer-jobs'",),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/doctor.py',
        ),
    },
    "obs.slo.burn.fast": {
        "type": 'float',
        "defaults": ('14.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.burn.history": {
        "type": 'int',
        "defaults": ('5',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.burn.min-windows": {
        "type": 'int',
        "defaults": ('2',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.burn.slow": {
        "type": 'float',
        "defaults": ('2.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.class.map": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p0.availability": {
        "type": 'float',
        "defaults": ('0.99',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p0.token.p99.ms": {
        "type": 'float',
        "defaults": ('500.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p0.ttft.p99.ms": {
        "type": 'float',
        "defaults": ('2000.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p1.availability": {
        "type": 'float',
        "defaults": ('0.99',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p1.token.p99.ms": {
        "type": 'float',
        "defaults": ('500.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p1.ttft.p99.ms": {
        "type": 'float',
        "defaults": ('2000.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p2.availability": {
        "type": 'float',
        "defaults": ('0.99',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p2.token.p99.ms": {
        "type": 'float',
        "defaults": ('500.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p2.ttft.p99.ms": {
        "type": 'float',
        "defaults": ('2000.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p3.availability": {
        "type": 'float',
        "defaults": ('0.99',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p3.token.p99.ms": {
        "type": 'float',
        "defaults": ('500.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.p3.ttft.p99.ms": {
        "type": 'float',
        "defaults": ('2000.0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.window.fast": {
        "type": 'int',
        "defaults": ('3',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.slo.window.slow": {
        "type": 'int',
        "defaults": ('12',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/slo.py',
        ),
    },
    "obs.trainer.port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/trainer.py',
        ),
    },
    "obs.trainer.registry": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/trainer.py',
        ),
    },
    "obs.trainer.service": {
        "type": 'str',
        "defaults": ("'/trainer-jobs'",),
        "namespace": 'obs',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/obs/trainer.py',
        ),
    },
    "parallel.lowp.chunk-matmul": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.codec": {
        "type": 'str',
        "defaults": ("'int8'",),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.guard.rel-tol": {
        "type": 'float',
        "defaults": ('0.25',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.guard.steps": {
        "type": 'int',
        "defaults": ('50',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.quant.buckets": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.quant.group": {
        "type": 'int',
        "defaults": ('1024',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.quant.tp": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.quant.zero1-gather": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.sync.guard.rel-tol": {
        "type": 'float',
        "defaults": ('2.0',),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.sync.mode": {
        "type": 'str',
        "defaults": ("'skip'",),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.lowp.sync.schedule": {
        "type": 'str',
        "defaults": ("'full'",),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "parallel.parity": {
        "type": 'str',
        "defaults": ("'bitwise'",),
        "namespace": 'parallel',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/parallel/lowp/__init__.py',
        ),
    },
    "registry.port": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'registry',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/registry.py',
        ),
    },
    "registry.sweep.interval": {
        "type": 'time',
        "defaults": ('1.0',),
        "namespace": 'registry',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/registry.py',
        ),
    },
    "serving.autoscale.backlog.high": {
        "type": 'float',
        "defaults": ('512.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.breach.polls": {
        "type": 'int',
        "defaults": ('2',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.cooldown": {
        "type": 'time',
        "defaults": ('30.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.doctor": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.drain.timeout": {
        "type": 'time',
        "defaults": ('120.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.horizon": {
        "type": 'time',
        "defaults": ('60.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.idle.polls": {
        "type": 'int',
        "defaults": ('5',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.interval": {
        "type": 'time',
        "defaults": ('10.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.lead.max": {
        "type": 'float',
        "defaults": ('0.3',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.max": {
        "type": 'int',
        "defaults": ('8',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.min": {
        "type": 'int',
        "defaults": ('1',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.prefill.max": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.prefill.min": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.queue.high": {
        "type": 'float',
        "defaults": ('2.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.scalein.ttft.frac": {
        "type": 'float',
        "defaults": ('0.5',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.scrape.timeout": {
        "type": 'time',
        "defaults": ('2.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/signals.py',
        ),
    },
    "serving.autoscale.slo.burn": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.ttft.p99.slo": {
        "type": 'time',
        "defaults": ('2.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.util.high": {
        "type": 'float',
        "defaults": ('0.85',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.autoscale.util.low": {
        "type": 'float',
        "defaults": ('0.3',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/autoscale/controller.py',
        ),
    },
    "serving.http.auth.anonymous.allowed": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/server.py',
        ),
    },
    "serving.http.auth.secret": {
        "type": 'str',
        "defaults": ("''",),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/server.py',
        ),
    },
    "serving.kv.block.size": {
        "type": 'int',
        "defaults": ('16',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.codec": {
        "type": 'str',
        "defaults": ("'raw'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.dfs.dir": {
        "type": 'str',
        "defaults": ("'/kvcache'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.dfs.enable": {
        "type": 'bool',
        "defaults": ('<dynamic>',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.dfs.min-refs": {
        "type": 'int',
        "defaults": ('1',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.drain.persist": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.fetch.window": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.hbm.bytes": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.host.bytes": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.kv.num.blocks": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.loader.io.workers": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'serving',
        "documented": True, "sites": 2,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.longctx.chips": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.decode.fetch.windows": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.decode.pipeline": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.decode.sampler": {
        "type": 'str',
        "defaults": ("'device'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.decode.tail.tokens": {
        "type": 'int',
        "defaults": ('256',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.decode.window.blocks": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.enabled": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.longctx.max.tokens": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.min.tokens": {
        "type": 'int',
        "defaults": ('4096',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.longctx.sp.mode": {
        "type": 'str',
        "defaults": ("'ring'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/longctx/plane.py',
        ),
    },
    "serving.max.batch": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.max.context": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.max.lanes": {
        "type": 'int',
        "defaults": ('16',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.max.new.tokens": {
        "type": 'int',
        "defaults": ('1024',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/server.py',
        ),
    },
    "serving.moe.a2a.codec": {
        "type": 'str',
        "defaults": ("'int8'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.moe.capacity.factor": {
        "type": 'float',
        "defaults": ('0.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.moe.shards": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.parity": {
        "type": 'str',
        "defaults": ("'bitwise'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "serving.prefill.chunk": {
        "type": 'int',
        "defaults": ('16',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.prefix_cache.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.qos.decay.factor": {
        "type": 'float',
        "defaults": ('0.5',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
        ),
    },
    "serving.qos.decay.period": {
        "type": 'time',
        "defaults": ('5.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
        ),
    },
    "serving.qos.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.qos.levels": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'serving',
        "documented": True, "sites": 2,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.qos.queue.max": {
        "type": 'int',
        "defaults": ('256',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
        ),
    },
    "serving.qos.retry.after": {
        "type": 'time',
        "defaults": ('1.0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
        ),
    },
    "serving.qos.shed.queue.depth": {
        "type": 'int',
        "defaults": ('32',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
        ),
    },
    "serving.qos.thresholds": {
        "type": 'list',
        "defaults": ('<absent>',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/qos.py',
        ),
    },
    "serving.registry.record.ttl": {
        "type": 'time',
        "defaults": ('<dynamic>',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/registry.py',
        ),
    },
    "serving.registry.ttl": {
        "type": 'time',
        "defaults": ('10.0',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/registry.py',
        ),
    },
    "serving.role": {
        "type": 'str',
        "defaults": ("'mixed'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.router.affinity.enabled": {
        "type": 'bool',
        "defaults": ('True',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/router.py',
        ),
    },
    "serving.router.affinity.max.imbalance": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/router.py',
        ),
    },
    "serving.router.affinity.prefix.tokens": {
        "type": 'int',
        "defaults": ('64',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/router.py',
        ),
    },
    "serving.router.max.retries": {
        "type": 'int',
        "defaults": ('6',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/router.py',
        ),
    },
    "serving.router.prefill.min.tokens": {
        "type": 'int',
        "defaults": ('32',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/router.py',
        ),
    },
    "serving.router.prefill.timeout": {
        "type": 'time',
        "defaults": ('20.0',),
        "namespace": 'serving',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/router.py',
        ),
    },
    "serving.speculate.k": {
        "type": 'int',
        "defaults": ('0',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.speculate.ngram": {
        "type": 'int',
        "defaults": ('3',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/service.py',
        ),
    },
    "serving.weights.codec": {
        "type": 'str',
        "defaults": ("'int8'",),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "serving.weights.embed": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "serving.weights.group": {
        "type": 'int',
        "defaults": ('64',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "serving.weights.guard.min-agree": {
        "type": 'float',
        "defaults": ('0.95',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "serving.weights.guard.rel-tol": {
        "type": 'float',
        "defaults": ('0.25',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "serving.weights.head": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": 'serving',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/serving/weightplane.py',
        ),
    },
    "tracing.collector.max-spans": {
        "type": 'int',
        "defaults": ('<dynamic>',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.flight.max-traces": {
        "type": 'int',
        "defaults": ('<dynamic>',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.slow.ckpt.ms": {
        "type": 'float',
        "defaults": ('30000.0',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.slow.client.ms": {
        "type": 'float',
        "defaults": ('2000.0',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.slow.rpc.ms": {
        "type": 'float',
        "defaults": ('300.0',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.slow.serving.ms": {
        "type": 'float',
        "defaults": ('1000.0',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.slow.step.ms": {
        "type": 'float',
        "defaults": ('1000.0',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
    "tracing.slow.xceiver.ms": {
        "type": 'float',
        "defaults": ('500.0',),
        "namespace": 'tracing',
        "documented": True, "sites": 1,
        "files": (
            'hadoop_tpu_torch/tracing.py',
        ),
    },
}

PATTERNS = {
    "*.backoff.enable": {
        "type": 'bool',
        "defaults": ('False',),
        "namespace": '*',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
    "*.callqueue.impl": {
        "type": 'str',
        "defaults": ("'fifo'",),
        "namespace": '*',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
    "*.scheduler.impl": {
        "type": 'str',
        "defaults": ("'decay'", "'default'",),
        "namespace": '*',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
    "*.scheduler.priority.levels": {
        "type": 'int',
        "defaults": ('4',),
        "namespace": '*',
        "documented": False, "sites": 1,
        "files": (
            'hadoop_tpu_torch/ipc/callqueue.py',
        ),
    },
}
