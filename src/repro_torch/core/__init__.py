"""The paper's maths on tensors: Gaussian algebra, bandwidths, metrics, partitions."""
