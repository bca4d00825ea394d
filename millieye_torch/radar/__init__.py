from millieye_torch.radar.projection import (
    load_calib,
    project_camera_xyz_to_uv,
    radar_points_to_image,
)
from millieye_torch.radar.dbscan import dbscan, cluster_points
from millieye_torch.radar.hungarian import assign
from millieye_torch.radar.kalman import ClusterKalman
from millieye_torch.radar.tracker import ClusterTracker
from millieye_torch.radar.pipeline import RadarPipeline, RadarParams
from millieye_torch.radar.viz import (draw_radar_points, draw_cluster_boxes,
                                      draw_detections)
