"""SLAM pipelines assembled from the ops: frontend, map state, tracking,
local mapping and the monocular System facade."""
