from hugs_tpu_torch.render.camera import Camera, make_camera
from hugs_tpu_torch.render.project import ProjectedGaussians, project_gaussians
from hugs_tpu_torch.render.renderer import render, render_human_scene
