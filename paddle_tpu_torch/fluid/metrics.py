"""Host-side streaming metrics (counterpart of ``paddle_tpu/fluid/
metrics.py``): numpy only.  Each ``update`` takes fetched values as numpy
arrays, numbers or tensors (a tensor on the card is copied to the host)."""

from __future__ import annotations

import numpy as np

__all__ = ["MetricBase", "CompositeMetric", "Accuracy", "Precision", "Recall",
           "ChunkEvaluator", "EditDistance", "Auc", "DetectionMAP"]


def _host(x) -> np.ndarray:
    """``x`` as a numpy array; a tensor (on any device) copied to the
    host."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _first(x) -> int:
    return int(_host(x).reshape(-1)[0])


class MetricBase:
    def __init__(self, name):
        self._name = name or self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith("_"):
                continue
            if isinstance(value, (int, float)):
                setattr(self, attr, 0)
            elif isinstance(value, (np.ndarray,)):
                setattr(self, attr, np.zeros_like(value))
            elif isinstance(value, list):
                setattr(self, attr, [])

    def update(self, preds, labels):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(_host(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated")
        return self.value / self.weight


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(_host(preds)).astype(np.int64).reshape(-1)
        labels = _host(labels).astype(np.int64).reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall else 0.0


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += _first(num_infer_chunks)
        self.num_label_chunks += _first(num_label_chunks)
        self.num_correct_chunks += _first(num_correct_chunks)

    def eval(self):
        precision = (float(self.num_correct_chunks) / self.num_infer_chunks
                     if self.num_infer_chunks else 0.0)
        recall = (float(self.num_correct_chunks) / self.num_label_chunks
                  if self.num_label_chunks else 0.0)
        f1 = (2 * precision * recall / (precision + recall)
              if self.num_correct_chunks else 0.0)
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = _host(distances)
        self.total_distance += float(np.sum(distances))
        self.seq_num += _first(seq_num)
        self.instance_error += int(np.sum(distances != 0))

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data accumulated")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1)
        self._stat_neg = np.zeros(num_thresholds + 1)

    def update(self, preds, labels):
        preds = _host(preds)
        labels = _host(labels).reshape(-1)
        pos_prob = preds[:, -1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip((pos_prob * self._num_thresholds).astype(np.int64), 0,
                      self._num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tot_pos = float(self._stat_pos.sum())
        tot_neg = float(self._stat_neg.sum())
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        pos_cum = np.cumsum(self._stat_pos[::-1])
        neg_cum = np.cumsum(self._stat_neg[::-1])
        prev_pos = np.concatenate([[0.0], pos_cum[:-1]])
        prev_neg = np.concatenate([[0.0], neg_cum[:-1]])
        area = float(np.sum((neg_cum - prev_neg) * (pos_cum + prev_pos) / 2.0))
        return area / (tot_pos * tot_neg)


class DetectionMAP(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.has_state = None

    def update(self, value, weight=None):
        self.has_state = value

    def eval(self):
        return self.has_state
