from metrics_tpu_torch.functional.pairwise.cosine import pairwise_cosine_similarity  # noqa: F401
from metrics_tpu_torch.functional.pairwise.euclidean import pairwise_euclidean_distance  # noqa: F401
from metrics_tpu_torch.functional.pairwise.linear import pairwise_linear_similarity  # noqa: F401
from metrics_tpu_torch.functional.pairwise.manhattan import pairwise_manhattan_distance  # noqa: F401
