"""Fixed window capacities of the per-frame and per-keyframe stages.

The reference keeps these as module constants beside their users
(tracking.py, mapping.py, crf.py); the port gathers them here. Each is a
static shape: a window is a top-k over a mask, so the point capacity of
the map must reach the point windows.
"""

LOCAL_POINTS = 4096   # tracked local-map window (tracking.track_step)

BA_CAMS = 32          # local-BA cameras: covisible window + fixed observers
BA_POINTS = 4096      # local-BA points; also fuse_duplicates' candidates

TRIANG_NEIGHBORS = 4  # covisible partners searched for new points
TRIANG_CAP = 256      # new points per neighbour pair

REFRESH_KFS = 12      # observing-keyframe window of refresh_point_stats
REFRESH_POINTS = BA_POINTS

CRF_TRACKS = 4096     # nodes of the CRF graph
RECENCY_WINDOW = 30   # frames: tracks seen within it join the CRF
