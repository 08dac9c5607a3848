"""Share of the exact 32 nearest rows (brute force by the reference) that a
sealed segment's NN-Descent graph holds, over sampled nodes."""


def read(record):
    return record.values.get("knn.recall_at_32")
