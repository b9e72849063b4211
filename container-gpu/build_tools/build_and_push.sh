#!/bin/bash
# Build one of the port's GPU images and push it to ECR, creating the
# repository if it is missing.  Prints the image URI.
#
#   IMAGE_KIND=train (default): container-gpu/Dockerfile, the image to
#     pass as maskrcnn.image / serve.image / autoscaler.image to the GPU
#     charts;
#   IMAGE_KIND=viz: container-gpu-viz/Dockerfile, FROM the train image
#     (BASE_IMAGE, default <registry>/eksml-gpu:<IMAGE_TAG>), to pass as
#     jupyter.image to charts/maskrcnn-gpu.
#
# Usage: [IMAGE_KIND=train|viz] [REGION=us-west-2] [IMAGE_NAME=...] \
#        [IMAGE_TAG=latest] [BASE_IMAGE=...] \
#        bash container-gpu/build_tools/build_and_push.sh
#
# Needs docker, the AWS CLI with credentials, and network access (the
# CUDA base image, the PyTorch wheels and PyPI).

set -euo pipefail
cd "$(dirname "$0")"
REPO_ROOT="$(cd ../.. && pwd)"

IMAGE_KIND=${IMAGE_KIND:-train}
REGION=${REGION:-us-west-2}
IMAGE_TAG=${IMAGE_TAG:-latest}
ACCOUNT=${ACCOUNT:-$(aws sts get-caller-identity --query Account --output text)}
REGISTRY="${ACCOUNT}.dkr.ecr.${REGION}.amazonaws.com"

case "$IMAGE_KIND" in
  train)
    IMAGE_NAME=${IMAGE_NAME:-eksml-gpu}
    DOCKERFILE="$REPO_ROOT/container-gpu/Dockerfile"
    BUILD_ARGS=()
    ;;
  viz)
    IMAGE_NAME=${IMAGE_NAME:-eksml-gpu-viz}
    DOCKERFILE="$REPO_ROOT/container-gpu-viz/Dockerfile"
    BUILD_ARGS=(--build-arg "BASE_IMAGE=${BASE_IMAGE:-${REGISTRY}/eksml-gpu:${IMAGE_TAG}}")
    ;;
  *)
    echo "unknown IMAGE_KIND=$IMAGE_KIND (train or viz)" >&2
    exit 2
    ;;
esac
IMAGE="${REGISTRY}/${IMAGE_NAME}:${IMAGE_TAG}"

aws ecr describe-repositories --region "$REGION" \
    --repository-names "$IMAGE_NAME" >/dev/null 2>&1 || \
  aws ecr create-repository --region "$REGION" \
    --repository-name "$IMAGE_NAME" >/dev/null
aws ecr get-login-password --region "$REGION" | \
  docker login --username AWS --password-stdin "$REGISTRY"

docker build -t "$IMAGE" "${BUILD_ARGS[@]}" -f "$DOCKERFILE" "$REPO_ROOT"
docker push "$IMAGE"
echo "$IMAGE"
