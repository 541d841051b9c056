"""Batching, thread-parallel loading and host-to-device copies.

The counterpart of ``eve_tpu/data/loader.py``:

- ``rebase_timestamps`` and ``collate`` are eve_tpu's;
- ``DataLoader`` is eve_tpu's thread-pool loader with a bounded ordered
  prefetch window and the stateless ``(seed, epoch)`` numpy shuffle, so
  for the same seed and epoch the order is eve_tpu's exactly, and
  ``fast_forward`` puts a resumed run where the interrupted one stood.
  With ``shard=(index, count)`` it reads only rows ``[index * b / count,
  (index + 1) * b / count)`` of each batch of ``b = batch_size`` clips of
  that same order: the clips one data-parallel rank trains on. So the
  ranks of a world together read the one-loader order clip for clip, and
  none shuffles a slice of its own. A ragged final batch fills a rank's
  missing rows with the batch's last clip (``shard_rows`` says how many
  are real);
- ``DevicePrefetcher`` takes the place of eve_tpu's: a producer thread
  stages each batch in pinned host memory and copies it with
  ``non_blocking`` copies on a side stream, and records an event that the
  consumer's stream waits on before it reads the batch. The queue is
  bounded and every put gives up once the consumer is gone, so an
  abandoned iteration releases the thread and its batches.

A dataset needs only ``__len__`` and ``__getitem__`` (a dict of numpy
arrays per clip).
"""

import queue as queue_lib
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

STRING_KEYS = ('participant', 'subfolder', 'camera')
TIMESTAMP_KEYS = ('timestamps', 'screen_timestamps')


def rebase_timestamps(ts):
    """Per-clip rebase of int64 nanosecond stamps to float32-safe values.

    Real frames become (ts - first_real + 1); padded frames stay 0. Only
    timestamp differences feed the model, and raw epoch nanoseconds would
    lose hundreds of ms of precision in float32.
    """
    ts = np.asarray(ts)
    out = np.zeros(ts.shape, np.float32)
    for b in range(ts.shape[0]):
        row = ts[b]
        real = row > 0
        if real.any():
            first = row[real].min()
            out[b][real] = (row[real] - first + 1).astype(np.float32)
    return out


def collate(items):
    """List of per-clip dicts -> one batch dict (numpy stacked)."""
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        batch[key] = vals if key in STRING_KEYS else np.stack(vals)
    return batch


def split_host_batch(batch, exclude=('screen_full_frame',)):
    """A collated batch -> ``(tensors, host_extras)``.

    Timestamps are rebased to float32 (the raw stamps stay on the host as
    ``<key>_ns``), float64 becomes float32 and int64 int32; string keys
    and ``exclude`` stay on the host.
    """
    tensors, extras = {}, {}
    for key, value in batch.items():
        if key in STRING_KEYS or key in exclude or \
                not isinstance(value, np.ndarray):
            extras[key] = value
            continue
        if key in TIMESTAMP_KEYS:
            extras[key + '_ns'] = value
            value = rebase_timestamps(value)
        elif value.dtype == np.float64:
            value = value.astype(np.float32)
        elif value.dtype == np.int64:
            value = value.astype(np.int32)
        tensors[key] = torch.from_numpy(
            np.require(value, requirements=('C', 'W')))
    return tensors, extras


def to_device(batch, device):
    """A collated batch -> ``(device tensors, host_extras)``, copied on
    the current stream (the prefetcher's path is ``DevicePrefetcher``)."""
    tensors, extras = split_host_batch(batch)
    return {k: v.to(device) for k, v in tensors.items()}, extras


class DataLoader:
    """Ordered, thread-parallel batch loader with bounded prefetch.

    ``indices`` restricts iteration to a subset of the dataset (the
    live-validation subset). ``shard=(index, count)`` yields only one
    rank's rows of each batch (see the module docstring); ``batch_size``
    stays the whole batch's, so lengths and ``fast_forward`` count whole
    batches.
    """

    def __init__(self, dataset, batch_size, shuffle=False, drop_last=False,
                 num_workers=4, seed=0, prefetch=2, indices=None,
                 shard=None):
        self.dataset = dataset
        self.batch_size = batch_size
        if shard is not None:
            index, count = shard
            if not 0 <= index < count or batch_size % count:
                raise ValueError('shard %r of a batch of %d clips: the batch '
                                 'must divide by the count'
                                 % (shard, batch_size))
        self.shard = shard
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.prefetch = max(1, prefetch)
        self.indices = None if indices is None else list(indices)
        self.seed = seed
        # The shuffle order derives from (seed, epoch), so a resumed run
        # can rebuild where the interrupted run's data stream stood.
        # ``epoch`` counts fully consumed iterations; ``_skip_next`` skips
        # the consumed batches of a partial epoch.
        self.epoch = 0
        self._skip_next = 0

    def fast_forward(self, num_batches):
        """Position the loader as if ``num_batches`` had been drawn."""
        per_epoch = len(self)
        if per_epoch <= 0:
            return
        self.epoch = num_batches // per_epoch
        self._skip_next = num_batches % per_epoch

    @property
    def num_entries(self):
        return (len(self.indices) if self.indices is not None
                else len(self.dataset))

    def __len__(self):
        n = self.num_entries
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def index_batches(self):
        """The dataset indices of each batch of the current epoch."""
        order = (np.asarray(self.indices) if self.indices is not None
                 else np.arange(len(self.dataset)))
        if self.shuffle:
            order = order.copy()
            np.random.RandomState(
                (self.seed * 1000003 + self.epoch) % (2 ** 32)
            ).shuffle(order)
        batches = []
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                continue
            if self.shard is not None:
                start, stop = self._shard_bounds()
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], self.batch_size -
                                      len(chunk))])[start:stop]
            batches.append(chunk)
        return batches

    def _shard_bounds(self):
        index, count = self.shard
        per = self.batch_size // count
        return index * per, (index + 1) * per

    def shard_rows(self, batch_index):
        """How many of this rank's rows of batch ``batch_index`` (of an
        epoch, from 0) are real clips; the rest repeat the last clip of a
        ragged final batch."""
        start, stop = self._shard_bounds() if self.shard is not None else (
            0, self.batch_size)
        first = batch_index * self.batch_size + start
        return max(0, min(stop - start, self.num_entries - first))

    def __iter__(self):
        batches = self.index_batches()
        if self._skip_next:
            batches = batches[self._skip_next:]
            self._skip_next = 0
        yield from self._iter_batches(batches)
        # A fully consumed iteration advances the epoch; an abandoned one
        # leaves the position to fast_forward.
        self.epoch += 1

    def _iter_batches(self, batches):
        if self.num_workers == 0:
            for chunk in batches:
                yield collate([self.dataset[int(i)] for i in chunk])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit_batch(chunk):
                return [pool.submit(self.dataset.__getitem__, int(i))
                        for i in chunk]

            it = iter(batches)
            window = [submit_batch(chunk) for _, chunk in
                      zip(range(self.prefetch), it)]
            while window:
                futures = window.pop(0)
                window.extend(submit_batch(chunk)
                              for chunk in next_or_empty(it))
                yield collate([f.result() for f in futures])


def next_or_empty(it):
    """``[next(it)]``, or ``[]`` when ``it`` is exhausted."""
    try:
        return [next(it)]
    except StopIteration:
        return []


class DevicePrefetcher:
    """Iterate a DataLoader as ``(device tensors, host_extras)``.

    On a CUDA device the copies run on a side stream from pinned memory,
    ``depth`` batches ahead of the consumer; on the CPU the tensors are
    the host's.
    """

    def __init__(self, loader, device, depth=2):
        self.loader = loader
        self.device = torch.device(device)
        self.depth = depth

    def _stage(self, batch, stream):
        tensors, extras = split_host_batch(batch)
        if stream is None:
            return tensors, extras, None
        with torch.cuda.stream(stream):
            tensors = {k: v.pin_memory().to(self.device, non_blocking=True)
                       for k, v in tensors.items()}
            ready = torch.cuda.Event()
            ready.record(stream)
        return tensors, extras, ready

    def __iter__(self):
        q = queue_lib.Queue(maxsize=self.depth)
        sentinel = object()
        stop = threading.Event()
        cuda = self.device.type == 'cuda'
        stream = torch.cuda.Stream(self.device) if cuda else None

        def put_or_abandon(item):
            # Every put is bounded: once the consumer is gone (an early
            # break or an exception in the training loop) the thread
            # returns instead of blocking forever on a full queue.
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue_lib.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self.loader:
                    if not put_or_abandon(self._stage(batch, stream)):
                        return
                put_or_abandon(sentinel)
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                put_or_abandon(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                tensors, extras, ready = item
                if ready is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(ready)
                    for t in tensors.values():
                        # The allocator must not hand this memory to the
                        # side stream again before the consumer is done.
                        t.record_stream(consumer)
                yield tensors, extras
            thread.join()
        finally:
            stop.set()
