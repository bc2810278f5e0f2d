"""Three-stage host<->device transfer pipeline.

Serializing upload -> compute -> download leaves the card idle while
frames cross PCIe.  ``pipelined_map`` overlaps them: a stager thread
uploads item i+1 while the caller's dispatch runs on item i and a
fetcher thread drains finished outputs.

Error semantics: an exception in any stage cancels the pipeline and
re-raises in the caller (no silent thread death, no deadlock — device
errors from asynchronous launches surface at the blocking fetch, which
is inside the fetcher thread here).

Spans (``utils/profiling.py``): ``pipeline.stage`` and ``pipeline.fetch``
on the stager's and the fetcher's threads; on the caller's,
``pipeline.wait_stage`` (waiting for the next upload),
``pipeline.dispatch`` and ``pipeline.wait_slot`` (a full queue).
"""

import queue as queue_mod
import threading
from concurrent.futures import ThreadPoolExecutor

from pvr_habitat_tpu_torch.utils.profiling import span


def pipelined_map(items, stage, dispatch, fetch, depth=4):
    """For each item: ``fetch(dispatch(stage(item)))`` with the three
    stages overlapped across items.  Returns the list of fetch results
    in item order.

    stage     host -> device upload (runs in the stager thread)
    dispatch  device compute dispatch (runs in the caller thread,
              serialized in item order)
    fetch     device -> host download, blocking (runs in the fetcher
              thread, serialized in item order)
    """
    items = list(items)
    if not items:
        return []
    results = [None] * len(items)
    outq = queue_mod.Queue(maxsize=depth)
    failure = []

    def stage_one(item):
        with span("pipeline.stage"):
            return stage(item)

    def fetch_worker():
        while True:
            entry = outq.get()
            if entry is None:
                return
            idx, dev = entry
            try:
                with span("pipeline.fetch"):
                    results[idx] = fetch(dev)
            except BaseException as exc:  # surface async device errors
                failure.append(exc)
                return

    fetcher = threading.Thread(target=fetch_worker, daemon=True)
    fetcher.start()
    try:
        with ThreadPoolExecutor(max_workers=1) as stager:
            nxt = stager.submit(stage_one, items[0])
            for j, _ in enumerate(items):
                with span("pipeline.wait_stage"):
                    staged = nxt.result()
                if j + 1 < len(items):
                    nxt = stager.submit(stage_one, items[j + 1])
                if failure:
                    raise failure[0]
                with span("pipeline.dispatch"):
                    dev = dispatch(staged)
                # bounded put, but never block forever on a dead fetcher
                with span("pipeline.wait_slot"):
                    while True:
                        try:
                            outq.put((j, dev), timeout=1.0)
                            break
                        except queue_mod.Full:
                            if failure:
                                raise failure[0]
    finally:
        # The sentinel put must not block forever when the fetcher
        # died with a full queue (it will never drain it).
        while True:
            try:
                outq.put(None, timeout=1.0)
                break
            except queue_mod.Full:
                if failure:
                    break  # fetcher already returned; nothing to signal
        fetcher.join()
    if failure:
        raise failure[0]
    return results
