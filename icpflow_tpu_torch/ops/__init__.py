from . import cluster, geometry, hist, icp, knn, segments  # noqa: F401
