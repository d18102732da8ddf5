"""Per-executor IPC manager: named queues + a kv store — counterpart of
``tensorflowonspark_tpu/manager.py``.

Maps the reference's TFManager (reference: TFManager.py:14-83): a
`multiprocessing.managers.BaseManager` that proxies `JoinableQueue`s (named
'input'/'output'/'error'/'control') and a key-value dict between the feeder
process (producer), the training process (consumer), and — for evaluator
nodes — the remote driver.

Modes (reference: TFManager.py:40-65):
- 'local'  — bound to loopback; reachable only from processes on this host.
- 'remote' — bound to all interfaces so the driver can push shutdown
  sentinels into control queues (reference: TFCluster.py:186-194).
"""
import logging
import multiprocessing as mp
from multiprocessing.managers import BaseManager

from . import util

logger = logging.getLogger(__name__)

# Server-process globals (exist only inside the manager server process;
# reference: TFManager.py:20-22).
_qdict = {}
_kdict = {}


def _get_queue(qname):
    if qname not in _qdict:
        # Raising (vs returning None) matters: BaseManager wraps every return
        # value in a proxy, so a None return would still look truthy.
        raise KeyError(qname)
    return _qdict[qname]


def _has_queue(qname):
    return qname in _qdict


def _get(key):
    return _kdict.get(key)


def _set(key, value):
    _kdict[key] = value


class QueueManager(BaseManager):
    """BaseManager exposing get_queue/get/set proxies (reference: TFManager.py:14-37)."""


QueueManager.register("get_queue", callable=_get_queue)
QueueManager.register("has_queue", callable=_has_queue)
QueueManager.register("get", callable=_get)
QueueManager.register("set", callable=_set)


def _init_server(queue_names):
    """Populate the queue dict INSIDE the manager server process.

    Using BaseManager's initializer (rather than pre-filling module globals in
    the parent) keeps this correct under the 'spawn' start method, where the
    server process re-imports this module and would otherwise see empty dicts.
    """
    for qname in queue_names:
        _qdict[qname] = mp.JoinableQueue()


def start(authkey, queues, mode="local"):
    """Start a manager server process holding `queues` (reference: TFManager.py:40-65).

    Returns the started manager; its reachable address is at `.address`.
    `authkey` is bytes (a uuid4 in practice) gating access.
    """
    if mode == "remote":
        addr = ("", 0)  # all interfaces; reachable by the driver
    else:
        addr = ("localhost", 0)
    mgr = QueueManager(address=addr, authkey=authkey)
    mgr.start(initializer=_init_server, initargs=(list(queues),))

    host = util.get_ip_address() if mode == "remote" else "localhost"
    # mgr.address gives ('', port) in remote mode; substitute a routable host.
    port = mgr.address[1]
    mgr._tfos_addr = (host, port)
    # CRITICAL: keep a module-global reference.  BaseManager registers a
    # weakref-triggered finalizer that sends the server a shutdown message as
    # soon as the manager OBJECT is garbage-collected — so a manager held
    # only in a local variable dies with the enclosing frame.  The reference
    # relied on the same trick (module global `mgr`, TFManager.py:20-22).
    _started_managers.append(mgr)
    logger.info("started %s queue manager on %s (queues=%s)", mode, mgr._tfos_addr, queues)
    return mgr


_started_managers = []


def get_value(mgr, key):
    """Unwrap a kv value from its AutoProxy (proxies str-ify with quotes)."""
    proxy = mgr.get(key)
    return proxy._getvalue() if proxy is not None else None


def connect(addr, authkey):
    """Connect to a running manager (reference: TFManager.py:68-83).

    Sets the connecting process's authkey first — required by multiprocessing
    when the connecting process didn't inherit it.
    """
    if not isinstance(authkey, bytes):
        authkey = bytes(authkey)
    mp.current_process().authkey = authkey
    mgr = QueueManager(address=(addr[0], int(addr[1])), authkey=authkey)
    mgr.connect()
    return mgr
